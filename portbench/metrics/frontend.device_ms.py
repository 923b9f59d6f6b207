"""Device ms a profiled frame of the kernels launched under the front
end's spans: `extract_orb`, and the stereo matcher's `stereo_match`,
`refine_stereo_subpixel` and `stereo_depth_for_frame`."""


def read(run):
    t = run.trace
    if t is None or t.ranges["frontend"][0] == 0:
        return None
    return 1e3 * t.ranges["frontend"][1] / t.frames
