"""rebuild_ms (model step and exchange: `models/gradients.py`
`_build_tables`, `_var_exchange`): device ms per step in the port's spans
cfd.rebuild and cfd.var_exchange (`cfd_proxy_tpu_torch/utils/spans.py`):
the solver step's table rebuild from the carried state and its ghost
refresh, pack and unpack included; the highest rank's.  None where the port
recorded neither span."""

from cfdbench.spans import span_ms


def read(ranks, problem):
    return span_ms(ranks, ("cfd.rebuild", "cfd.var_exchange"))
