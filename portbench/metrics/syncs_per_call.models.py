"""Waits of the host for the card in the traced calls, per call: the
program's `syncs` counter (kiwi_tpu_torch.profiling: device-to-host
copies, blocking host-to-device copies, stream and event
synchronizations), its difference over the traced calls."""


def read(run):
    t = run.trace
    c = getattr(t, "counters", None)
    return c.get("syncs", 0) / t.calls if c is not None and t.calls else None
