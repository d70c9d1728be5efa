"""Signed pools of requests, one module a kind of configuration."""
