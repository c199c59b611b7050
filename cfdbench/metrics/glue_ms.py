"""glue_ms (model step and exchange: `models/gradients.py` `_pack`,
`_exchange`, `_unpack`, `_build_tables`, `_var_exchange`, `parallel/`): device
ms per step of every activity whose name names neither a sweep nor the
chained update: pack, unpack, the loopback copy, fills, copies and the table
rebuild; the highest rank's.  0 where the step has none."""

from cfdbench.metrics import SWEEP, UPDATE, per_step_us


def read(ranks, problem):
    if not any(r["ops"] for r in ranks):
        return None
    return max(per_step_us(r, lambda n: SWEEP not in n and UPDATE not in n)
               for r in ranks) / 1e3
