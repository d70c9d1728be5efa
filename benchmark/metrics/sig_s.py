"""Signature lanes answered OK in the window, per second of it."""


def read(ctx):
    lanes = sum(r["lanes"] for r in ctx.requests
                if r["status"] == 0 and r["replied"] is not None
                and ctx.t0 <= r["replied"] < ctx.t1)
    return lanes / ctx.seconds if lanes else None
