"""Set-up: from the process's start to the window's start (the input's
generation, the program's import and builds, the device's context, one
warm-up compress)."""


def read(run):
    return run.setup_s
