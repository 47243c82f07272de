"""Device operations a frame of the datagen loop (``parallel/datagen.py``):
every kernel, copy and fill launched in the traced frames, over the
frames. It moves ``world_frames_per_s`` where the loop is bound by the
host's issue of small operations."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.ops) / tr.units
