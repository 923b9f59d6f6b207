"""Tracked frames per second: the window's frames whose pose was
available by the window's end, over the window's length. A frame the
tracker lost has no pose and does not count."""


def read(run):
    done = sum(1 for r in run.window
               if run.finalized_at(r) <= run.t_end and r.fd._pose_ok)
    return done / run.window_s
