"""stitchbench: the benchmark of imagestitch_tpu_torch on an NVIDIA H100.

One run stitches one synthetic micrograph project after another, in a closed
loop, through the entry a cell names, and prints one JSON line of metrics.
Everything a cell needs is found by name: its configuration under
``configs/``, its traffic mix under ``cells/``, its correctness limits under
``checks/``, each per-layer metric's reader under ``metrics/`` and the
reference's fusion for each fuse method under ``fusers/``.  See ``run.py``
for the command line.
"""
