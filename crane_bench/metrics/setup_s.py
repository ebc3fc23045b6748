"""setup_s: process start to the first step of the window."""


def read(ctx):
    return ctx.setup_s
