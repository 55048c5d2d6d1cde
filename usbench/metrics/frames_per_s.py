"""frames_per_s: every frame imaged in the window (each frame of an
ensemble once) over the window's length, host clock."""


def read(run):
    return run.frames_ok / run.window_s
