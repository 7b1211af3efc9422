"""Layer reorder: the engine's milliseconds a round run, over the window
(engine.LAST_RUN_STATS ``flush_wall_s``, which ends at the harvest's
device read, over ``rounds_run``)."""


def read(run):
    wall, rounds = run.engine("flush_wall_s"), run.engine("rounds_run")
    if len(wall) != len(rounds) or not sum(rounds):
        return None
    return 1000 * sum(wall) / sum(rounds)
