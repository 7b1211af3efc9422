"""Layer io: a compress's seconds in the program's stages ``scan``,
``load+parse`` and ``quantize+idcheck`` (short_mode.LAST_STAGE_SECONDS,
host clock), the window's mean."""


def read(run):
    return run.stage_s("scan", "load+parse", "quantize+idcheck")
