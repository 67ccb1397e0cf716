"""device_idle_share: 1 - device busy seconds / wall seconds over the
profiler's slice (one stream; busy is the union of its operations), in %."""


def read(slc):
    if not slc.ops or slc.wall_s <= 0:
        return None
    return 100.0 * (1.0 - slc.busy_s() / slc.wall_s)
