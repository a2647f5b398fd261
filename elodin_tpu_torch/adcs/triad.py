"""TRIAD deterministic attitude solution (counterpart of
``elodin_tpu/adcs/triad.py``)."""

from __future__ import annotations

import torch

from ..spatial import _as_f


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def triad(body_1, body_2, ref_1, ref_2) -> torch.Tensor:
    """DCM mapping reference-frame vectors into the body frame from two
    vector observations; batched over leading axes."""
    body_1, body_2, ref_1, ref_2 = (_as_f(x) for x in (body_1, body_2, ref_1, ref_2))
    r_r = _normalize(torch.linalg.cross(ref_1, ref_2))
    q_r = _normalize(ref_1)  # raw sensor vectors (nT-scale mags) must not
    s_r = torch.linalg.cross(q_r, r_r)  # scale the DCM rows
    m_r = torch.stack([q_r, r_r, s_r], dim=-2)  # rows
    r_b = _normalize(torch.linalg.cross(body_1, body_2))
    q_b = _normalize(body_1)
    s_b = torch.linalg.cross(q_b, r_b)
    m_b = torch.stack([q_b, r_b, s_b], dim=-1)  # columns (transpose of rows)
    return m_b @ m_r
