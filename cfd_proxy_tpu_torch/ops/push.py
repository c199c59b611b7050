"""K6, the push bench's kernel: N push phases in one launch.

Counterpart of the kernel `cfd_proxy_tpu/tools/icibench.py::build` makes
(`:75-111`): nph pushes of a (rows, S) buffer per shard through the fused
overlap kernel's transport, with the readiness barrier and the copies
switched by mode, to measure what the push machinery costs by itself.  The
kernel (csrc/push_bench.cu) runs the device code the fused kernel's peer
form runs (csrc/push_common.cuh).

`push_phases(sendbufs, peer, mode)` takes one rank's (P_local, nph, rows,
S) send buffers and a `Peer` transport (parallel/transport.py) and returns
the transport's persistent `recv`:

- "full": readiness barrier, stores, arrival wait — recv[dsts[p, k], k] =
  sendbufs[p, k], the production push;
- "nobar": the same without the barrier (right only while nothing reads
  recv between launches, as in the bench's chained loop);
- "baronly": the barrier alone; phase 0 is copied into the LOCAL recv,
  recv[p, 0] = sendbufs[p, 0], as the reference keeps one local copy so its
  chained loop depends on the kernel;
- "empty": that local copy and nothing else.

On CPU tensors the plain version runs: `push_phases_ref(sendbufs,
transport, mode)` over a `Loopback` or `Dist` transport.  Each mode counts
its launches in `push_phases.<mode>_launches` (`launch_counters()`).
"""

from __future__ import annotations

import torch

from cfd_proxy_tpu_torch.ops.blocksweep import PUSH_MODES
from cfd_proxy_tpu_torch.utils.errors import check

MODES = ("full", "nobar", "baronly", "empty")


def push_phases_ref(sendbufs: torch.Tensor, transport, mode: str = "full",
                    recv: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version.  full / nobar: the transport's exchange of every
    phase.  baronly / empty: phase 0 copied locally into `recv` (a zero
    buffer when not given), the other phases left as they are."""
    check(mode in MODES, "unknown push mode %r (one of %s)", mode,
          "/".join(MODES))
    if mode in ("full", "nobar"):
        return transport.exchange(sendbufs)
    if recv is None:
        recv = torch.zeros_like(sendbufs)
    recv[:, 0].copy_(sendbufs[:, 0])
    return recv


def push_phases(sendbufs: torch.Tensor, peer, mode: str = "full"
                ) -> torch.Tensor:
    """One launch of K6 on CUDA send buffers through `peer` (a `Peer`);
    on CPU send buffers `peer` is a `Loopback` or `Dist` transport and the
    plain version runs.  Returns recv (the peer's persistent buffer on
    CUDA, valid until the next launch on it)."""
    check(mode in MODES, "unknown push mode %r (one of %s)", mode,
          "/".join(MODES))
    check(isinstance(sendbufs, torch.Tensor) and sendbufs.dim() == 4,
          "sendbufs must be a (P_local, nph, rows, S) tensor")
    check(sendbufs.device.type in ("cpu", "cuda"), "unsupported device %s",
          sendbufs.device)
    if sendbufs.device.type == "cpu":
        return push_phases_ref(sendbufs, peer, mode)
    from cfd_proxy_tpu_torch.ops import _cuda

    check(getattr(peer, "name", None) == "peer", "push_phases on CUDA "
          "tensors takes a Peer transport, got %r", peer)
    peer.check_sendbufs(sendbufs)
    P, nph = sendbufs.shape[:2]
    dev = sendbufs.device
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_push_phases(
            sendbufs.data_ptr(), P, nph, peer.seg_bytes,
            peer.table.data_ptr(), peer.flags, peer.recv.data_ptr(),
            PUSH_MODES[mode], torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check_launch(rc, "push_phases")
    attr = mode + "_launches"
    setattr(push_phases, attr, getattr(push_phases, attr) + 1)
    return peer.recv


push_phases.count_attrs = tuple(m + "_launches" for m in MODES)
for _a in push_phases.count_attrs:
    setattr(push_phases, _a, 0)


def launch_counters() -> dict:
    """{instance name: (wrapper, count attribute)}: "push_phases_full",
    "push_phases_nobar", ... (as `blocksweep.launch_counters`)."""
    return {"push_phases_" + a[:-len("_launches")]: (push_phases, a)
            for a in push_phases.count_attrs}
