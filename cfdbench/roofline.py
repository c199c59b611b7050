"""The yardstick of the roofline shares: the problem's bytes and the chip's
peaks.

The bytes are the Green-Gauss problem's, from the global mesh and the number
of variables alone, each input read once and each output written once in
f32: per face its two point ids (2 × 4 B) and its normal (3 × 4 B), per point
its volume (4 B), its state (nvar × 4 B) and its gradients (3·nvar × 4 B).
No layout of the program enters, so a change of layout or kernel is read
against the same work.  On several chips each holds its share: the bytes ÷
chips.

Bytes bound the sweep: about 77 f32 operations a face at nvar 7 is 1.4
operations a byte, against the H100's 67 TFLOP/s ÷ 3.35 TB/s = 20.
"""

from __future__ import annotations

# published peaks of the SXM part at its 700 W limit (NVIDIA's data sheet)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flops": 67e12}}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def problem_bytes(nface: int, npoint: int, nvar: int) -> int:
    return nface * (2 * 4 + 3 * 4) + npoint * (4 + nvar * 4 + 3 * nvar * 4)


def peak(kind: str | None) -> dict:
    """The peaks of a card by its name; an unlisted card is read against
    the H100's (its result line names the card)."""
    return PEAKS.get(kind or DEFAULT_KIND, PEAKS[DEFAULT_KIND])


def least_seconds(problem: dict) -> float:
    """The least time one chip's share of the problem can take."""
    b = problem_bytes(problem["faces"], problem["points"], problem["nvar"])
    return b / problem["chips"] / peak(problem.get("kind"))["bytes_per_s"]
