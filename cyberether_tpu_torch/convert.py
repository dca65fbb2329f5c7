"""Carry tables and streaming state over from the JAX package.

Both take plain numpy arrays (``np.asarray`` of the JAX values), so this
module needs nothing of JAX:

- ``channelizer_tables_from_arrays``: a JAX ``Channelizer``'s ``_hp5``,
  ``_bperm5``, ``_fm_ref``, ``_bp4``, ``_rhs``, ``_Wr`` and ``_Wi`` ->
  the tables a port ``Channelizer`` installs with ``load_tables``;
- ``channelizer_state_from_arrays``: the ``{"hist"}`` state of
  ``step_pallas_v4`` -> the state of ``Channelizer.step_kernel``;
- ``channelizer_step_state_from_arrays``: the ``{"hist", "prev"}`` state
  of ``step`` / ``step_pallas`` -> the state of ``Channelizer.step`` and
  ``step_carry_kernel``;
- ``wbfm_taps_from_arrays``: a JAX ``WbfmReceiver``'s ``_taps`` and
  ``_ref`` -> what a port ``WbfmReceiver`` installs with ``load_taps``;
- ``wbfm_state_from_arrays``: the ``{"fir_hist", "prev"}`` state of
  ``step`` / ``step_pallas`` -> the state of ``WbfmReceiver.step`` and
  ``step_kernel``;
- ``spectrum_params_from_arrays``: a JAX ``SpectrumPipeline``'s
  ``_win``, ``_coeff``, ``_scale`` and ``_offset`` -> what a port
  ``SpectrumPipeline`` installs with ``load_params``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cyberether_tpu_torch.core.types import require_device


def channelizer_tables_from_arrays(arrays: Mapping[str, object],
                                   device: "str | torch.device" = "cuda"
                                   ) -> Dict[str, object]:
    """The JAX model's arrays ``{"hp5": (P, 2C), "bperm5": (2C, 2C),
    "bp4": (P, 2C, 2C), "rhs": (C, 1, P), "wr": (C, C), "wi": (C, C),
    "fm_ref": scalar}`` -> the same tables as float32 tensors on
    ``device``, with ``rhs`` as ``hp`` (P, C) = ``rhs[:, 0, :].T`` and
    ``fm_ref`` a float32-rounded python float."""
    dev = require_device(device)
    out: Dict[str, object] = {}
    for name, ndim in (("hp5", 2), ("bperm5", 2), ("bp4", 3), ("rhs", 3),
                       ("wr", 2), ("wi", 2)):
        a = np.asarray(arrays[name])
        if a.ndim != ndim or a.dtype != np.float32:
            raise ValueError(f"{name} must be a {ndim}-D float32 array; "
                             f"got {a.dtype} {a.shape}")
        out[name] = torch.tensor(a, device=dev)
    rhs = out.pop("rhs")
    if rhs.shape[1] != 1:
        raise ValueError(f"rhs must be (C, 1, P); got {tuple(rhs.shape)}")
    out["hp"] = rhs[:, 0, :].T.contiguous()
    out["fm_ref"] = float(np.float32(np.asarray(arrays["fm_ref"])))
    return out


def channelizer_state_from_arrays(arrays: Mapping[str, object],
                                  device: "str | torch.device" = "cuda"
                                  ) -> Dict[str, torch.Tensor]:
    """``{"hist": (P, 2C)}`` in its ingest dtype, on ``device``."""
    dev = require_device(device)
    hist = np.asarray(arrays["hist"])
    if hist.ndim != 2:
        raise ValueError(f"hist must be (P, 2C); got {hist.shape}")
    return {"hist": torch.tensor(hist, device=dev)}


def channelizer_step_state_from_arrays(arrays: Mapping[str, object],
                                       device: "str | torch.device" = "cuda"
                                       ) -> Dict[str, torch.Tensor]:
    """``{"hist": (2, C, P-1), "prev": (2, C)}`` float32 on ``device``."""
    dev = require_device(device)
    hist = np.asarray(arrays["hist"], np.float32)
    prev = np.asarray(arrays["prev"], np.float32)
    if hist.ndim != 3 or hist.shape[0] != 2 or \
            prev.shape != hist.shape[:2]:
        raise ValueError(f"hist must be (2, C, P-1) and prev (2, C); got "
                         f"{hist.shape} and {prev.shape}")
    return {"hist": torch.tensor(hist, device=dev),
            "prev": torch.tensor(prev, device=dev)}


def wbfm_taps_from_arrays(arrays: Mapping[str, object],
                          device: "str | torch.device" = "cuda"
                          ) -> Dict[str, object]:
    """``{"taps": (T,) float32 tensor on device, "ref": float}``, from
    the JAX model's ``_taps`` and ``_ref``."""
    dev = require_device(device)
    taps = np.asarray(arrays["taps"])
    if taps.ndim != 1 or taps.dtype != np.float32:
        raise ValueError(f"taps must be a 1-D float32 array; got "
                         f"{taps.dtype} {taps.shape}")
    return {"taps": torch.tensor(taps, device=dev),
            "ref": float(np.float32(np.asarray(arrays["ref"])))}


def spectrum_params_from_arrays(arrays: Mapping[str, object],
                                device: "str | torch.device" = "cuda"
                                ) -> Dict[str, object]:
    """``{"win": (n,) float32 tensor on device, "coeff", "scale",
    "offset": float}``, from a JAX ``SpectrumPipeline``'s ``_win``,
    ``_coeff``, ``_scale`` and ``_offset`` (the scalars float32-rounded
    python floats)."""
    dev = require_device(device)
    win = np.asarray(arrays["win"])
    if win.ndim != 1 or win.dtype != np.float32:
        raise ValueError(f"win must be a 1-D float32 array; got "
                         f"{win.dtype} {win.shape}")
    out: Dict[str, object] = {"win": torch.tensor(win, device=dev)}
    for name in ("coeff", "scale", "offset"):
        out[name] = float(np.float32(np.asarray(arrays[name])))
    return out


def wbfm_state_from_arrays(arrays: Mapping[str, object],
                           device: "str | torch.device" = "cuda"
                           ) -> Dict[str, torch.Tensor]:
    """``{"fir_hist": (2, T-1), "prev": (2,)}`` float32 on ``device``."""
    dev = require_device(device)
    hist = np.asarray(arrays["fir_hist"], np.float32)
    prev = np.asarray(arrays["prev"], np.float32)
    if hist.ndim != 2 or hist.shape[0] != 2 or prev.shape != (2,):
        raise ValueError(f"fir_hist must be (2, T-1) and prev (2,); got "
                         f"{hist.shape} and {prev.shape}")
    return {"fir_hist": torch.tensor(hist, device=dev),
            "prev": torch.tensor(prev, device=dev)}
