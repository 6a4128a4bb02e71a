"""ingest.s_per_frame: each project's wall through Stitcher.stitch_files
(the benchmark's clock) less the SequenceReport's t_register + t_compose,
summed over the window and divided by its frames: decode, gray and the
copy to the card."""


def read(run):
    frames = sum(p["frames"] for p in run.projects)
    return sum(p["wall"] - p["t_register"] - p["t_compose"]
               for p in run.projects) / frames
