"""register.s_per_frame: the program's SequenceReport.t_register (the host
clock around Stitcher.register, which ends in the records' readback),
summed over the window's projects and divided by their frames."""


def read(run):
    frames = sum(p["frames"] for p in run.projects)
    return sum(p["t_register"] for p in run.projects) / frames
