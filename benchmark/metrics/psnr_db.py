"""psnr_db: astcenc's "PSNR (LDR-RGBA)" of each texture of the set,
decoded by the reference from the blocks the window returned for it, the
mean over the set. Nothing where the configuration is HDR."""


def read(run):
    v = [q["psnr"] for q in run.quality.values() if "psnr" in q]
    if not v or len(v) != len(run.quality):
        return None
    return sum(v) / len(v)
