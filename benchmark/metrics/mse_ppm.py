"""mse_ppm: the mean squared error of each texture of the set, decoded by
the reference from the blocks the window returned for it, in the domain of
its PSNR (LDR: RGBA over 0..1; HDR: mPSNR's tone-mapped RGB over 0..1 at
the f-stops -10..+10), the mean over the set, in millionths. The same
error as ``psnr_db`` or ``mpsnr_db`` on a linear scale, where a loss of
quality reads PSNR x ln(10) / 10 times larger as a share than it does in
dB (8.5 times at 37 dB)."""


def read(run):
    v = [10.0 ** (-q.get("psnr", q.get("mpsnr", 0.0)) / 10.0)
         for q in run.quality.values()
         if "psnr" in q or "mpsnr" in q]
    if not v or len(v) != len(run.quality):
        return None
    return 1e6 * sum(v) / len(v)
