"""Host ms per wave in ``RetrievalEngine.plan_batch``'s planning
(``PackedRuntime.wave_times["plan_ms"]``: predicate compile and plan),
over the window's untraced waves."""


def read(run):
    if not run.waves or "plan_ms" not in run.wave_times:
        return None
    return run.wave_times["plan_ms"] / run.waves
