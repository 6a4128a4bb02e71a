"""The reference stitcher's fadeInAndFadeOut (ImageFusion.py:43-235): the
plain ramps across the shorter side of the overlap, or the corner weights
where under 65% of it was covered before the paste; the rect's empty
pixels take the frame pasted (Stitcher.py:498-504).  It is
``reference.fade``."""
from stitchbench.reference import fade as fuse  # noqa: F401
