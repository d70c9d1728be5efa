"""Seconds from the harness's start to the window's."""


def read(ctx):
    return ctx.setup_s
