"""frames_per_s: every frame of every project completed in the window,
over the seconds from the window's start to the end of its last project
(host clock)."""


def read(run):
    frames = sum(p["frames"] for p in run.projects)
    return frames / (run.window_end - run.window_start)
