"""Share of the scan batches eligible for SQ8 that ended on the fp32
scan, over the window: batches whose certificate failed and were re-run
(``sq8_stats["escalations"]``) and batches the runtime sent straight to
fp32 after a streak of failures (``"fallbacks"``), over all of them."""


def read(run):
    tried = run.sq8.get("batches", 0) + run.sq8.get("fallbacks", 0)
    if not tried:
        return None
    return 100.0 * (run.sq8.get("escalations", 0)
                    + run.sq8.get("fallbacks", 0)) / tried
