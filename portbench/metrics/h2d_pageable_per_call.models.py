"""Host-to-device copies from pageable memory in the traced calls, per
call: the program's `h2d_pageable` counter (kiwi_tpu_torch.profiling; each
is also one of `syncs`), its difference over the traced calls."""


def read(run):
    t = run.trace
    c = getattr(t, "counters", None)
    return c.get("h2d_pageable", 0) / t.calls if c is not None and t.calls else None
