"""Layer codecs: a compress's seconds in the program's stages
``block_streams_submit``, ``qbins_join`` and ``codec+write``
(short_mode.LAST_STAGE_SECONDS, host clock), the window's mean."""


def read(run):
    return run.stage_s("block_streams_submit", "qbins_join", "codec+write")
