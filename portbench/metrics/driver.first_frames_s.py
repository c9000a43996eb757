"""driver.first_frames_s: the benchmark's clock, with a synchronise after
each, over the first three frames: the eager frame (the BVH8 build, shade
tables, binning check), the captured frame and the first replay."""


def read(ctx):
    return ctx.first_frames_s
