"""setup_s: the process's start to the first timed request: imports, the
inputs, the system, kernel builds or loads, the warm-up requests."""


def read(run):
    return run.setup_s
