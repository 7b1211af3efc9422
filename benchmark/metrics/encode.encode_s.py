"""Layer encode: a compress's seconds in the program's stages
``assemble_contigs``, ``consensus``, every ``stitch[...]``, ``noise``
and ``second_chance`` (short_mode.LAST_STAGE_SECONDS, host clock), the
window's mean."""


def read(run):
    return run.stage_s("assemble_contigs", "consensus", "stitch[", "noise",
                       "second_chance")
