"""seq_p90_s: the 90th percentile (nearest rank) of the walls of all
projects in the window (host clock); a wall ends when every segment's
panorama is a host array."""
import math
import sys

P = 90


def read(run):
    walls = sorted(p["wall"] for p in run.projects)
    rank = math.ceil(P / 100 * len(walls))
    if len(walls) - rank < 10:
        print(f"seq_p{P}_s: {len(walls)} projects leave "
              f"{len(walls) - rank} beyond the percentile (under 10)",
              file=sys.stderr)
    return walls[rank - 1]
