"""compose.s_per_frame: the program's SequenceReport.t_compose (the host
clock around the segments' composition, which returns host arrays),
summed over the window's projects and divided by their frames."""


def read(run):
    frames = sum(p["frames"] for p in run.projects)
    return sum(p["t_compose"] for p in run.projects) / frames
