"""Serving path ``dense``: the renderer that the configuration's entry point
builds with no skip lists (the head+torso frame renderer, or the
hierarchical head), judged against the reference's no-skip frame. It lists
no kernel work, so no roofline or ``frame_mfu`` reads it."""

from port_bench.serve import Program, no_skip_frames as reference_frames, prepare  # noqa: F401

KERNELS = {}
