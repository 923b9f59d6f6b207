"""90th percentile over every frame handed in during the window of the
time from the start of the call that handed it in to its pose being
available (`FrameData._finalized_wall`, stamped by the tracker when the
frame is finalized, on every path). A frame still in flight at the
window's end counts with the time it has waited so far."""
from portbench import arith


def read(run):
    waits = [min(run.finalized_at(r), run.t_end) - r.t_call
             for r in run.window]
    return 1e3 * arith.percentile(waits, 90) if waits else None
