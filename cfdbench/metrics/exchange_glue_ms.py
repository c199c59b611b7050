"""exchange_glue_ms (model step and exchange: `models/gradients.py` `_pack`,
`_unpack`, the overlap wrappers' receive fill in `ops/blocksweep.py`):
device ms per step in the port's spans cfd.pack, cfd.recv_fill and
cfd.unpack (`cfd_proxy_tpu_torch/utils/spans.py`): the pack's index gather,
scale and cast, the fused kernel's receive buffer zeros, the unpack's copy;
the highest rank's.  None where the port recorded none of these spans."""

from cfdbench.spans import span_ms


def read(ranks, problem):
    return span_ms(ranks, ("cfd.pack", "cfd.recv_fill", "cfd.unpack"))
