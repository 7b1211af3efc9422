"""Layer encode: the share of the reads given to second chance that it
placed on the consensus, in %: 100 x the engine counters
``second_chance_placed`` over ``second_chance_in``
(engine.LAST_RUN_STATS), summed over the window's compresses. A read it
does not place goes to the literal stream. None where no compress gave
it a read."""


def read(run):
    got = [(c["engine"]["second_chance_in"],
            c["engine"]["second_chance_placed"]) for c in run.compresses
           if c["engine"].get("second_chance_in") is not None
           and c["engine"].get("second_chance_placed") is not None]
    given = sum(i for i, _ in got)
    if not given:
        return None
    return 100 * sum(p for _, p in got) / given
