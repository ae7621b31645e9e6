"""Kernel A's share of its roofline over the traced waves that ran the
fp32 scan: the least time of those waves' scan work (fp32 rows; fp32
CUDA-core peak) over the device time of the kernels named below.  A wave
ran the fp32 scan when the SQ8 path did not run (``quantize="none"``),
escalated or fell back."""

from vmbench import roofline

KERNELS = ("topk_seg_f32_pass",)


def _fp32(sq8):
    return (sq8["escalations"] or sq8["fallbacks"] or not sq8["batches"])


def read(run):
    prof = run.profile
    if prof is None:
        return None
    waves = [w for w in prof.waves if _fp32(w["sq8"])]
    t = prof.kernel_seconds(KERNELS)
    if t <= 0 or not waves:
        return None
    dim = int(run.config["dim"])
    least = sum(roofline.least_seconds(
        *roofline.scan_work(w["counts"], run.sizes, dim,
                            roofline.f32_row_bytes(dim)),
        roofline.PEAK_F32) for w in waves)
    return 100.0 * least / t
