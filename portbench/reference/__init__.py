"""The plain reference that decides `correct`.

Written from the specification of what the timed window computes, not
from the program's code: ORB features level by level (`orb.py`), the
frame's matches and pose (`track.py`, with the rigid motions of
`se3.py`), stereo depth (`stereo.py`) and the local bundle adjustment
(`ba.py`), each in the precision it is handed (float64 for the check,
float32 with TF32 on for the control), with products written as the
matrix products one writes plainly. Nothing here imports the program:
`compare.py` reads its outputs only to judge them.
"""
