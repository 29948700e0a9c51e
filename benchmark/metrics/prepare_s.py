"""Host seconds of the one make_frame_fn call of set-up (BVH or cluster
build, packing, upload, ray order), ending in a synchronize."""


def read(ctx):
    return ctx.prepare_s
