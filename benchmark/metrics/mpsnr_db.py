"""mpsnr_db: astcenc's "mPSNR (RGB)" over the f-stops -10..+10 of each
texture of the set, decoded by the reference from the blocks the window
returned for it, the mean over the set. Nothing where the configuration
is LDR."""


def read(run):
    v = [q["mpsnr"] for q in run.quality.values() if "mpsnr" in q]
    if not v or len(v) != len(run.quality):
        return None
    return sum(v) / len(v)
