"""setup_s: seconds from the process's start to the first timed frame."""


def read(ctx):
    return getattr(ctx, "setup_s", None)
