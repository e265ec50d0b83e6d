"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the reference ``Model.init_params`` tree with its
leaves as numpy arrays (``np.asarray`` of each leaf; no JAX needed here)
and returns the port's ``state_dict``.  The reference stacks the repeating
block group on a leading ``[G]`` axis (``groups/b0/...``); that axis is
unstacked into ``blocks.<i>``.  MLP weights arrive in the single-device
xyz layout ``[1, K, N]`` and become ``[K, N]``; the packed ``wqkv`` stays
packed and interleaved.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.maxeva_matmul import unshard_weight_xyz


def _tensor(a: Any) -> torch.Tensor:
    """numpy leaf -> torch tensor.  A bf16 leaf comes through ``np.asarray``
    as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects;
    it goes through float32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def from_jax_params(cfg: ArchConfig, params: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """Reference parameter tree -> the port's ``Model.state_dict()``."""
    if params.get("tail"):
        raise NotImplementedError("tail blocks belong to patterns this "
                                  "slice does not serve")
    grp = params["groups"]["b0"]
    sd = {"embed": _tensor(params["embed"]),
          "final_norm": _tensor(params["final_norm"])}
    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        sd[p + "ln1"] = _tensor(grp["ln1"][i])
        sd[p + "ln2"] = _tensor(grp["ln2"][i])
        sd[p + "attn.wqkv"] = _tensor(grp["attn"]["wqkv"][i])
        sd[p + "attn.wo"] = _tensor(grp["attn"]["wo"][i])
        for name in ("gate", "up", "down"):
            sd[p + "ffn." + name] = unshard_weight_xyz(
                _tensor(grp["ffn"][name][i]), 1).contiguous()
    return sd
