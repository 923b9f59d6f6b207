"""The patch gather's share of its roofline, in %: the least time its
launches of the profiled stretch could take, each input byte read once
and each output byte written once at the HBM's 3.35 TB/s
(`arith.gather_bytes` of the shapes each launch was given; 44,845,900 B
a bird frame), over their device time."""
from portbench import arith


def read(run):
    t = run.trace
    if t is None or t.gather_launches == 0 or t.gather_s <= 0:
        return None
    return 100.0 * (t.gather_bytes / arith.HBM_BYTES_PER_S) / t.gather_s
