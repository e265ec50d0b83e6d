"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the reference ``Model.init_params`` tree with its
leaves as numpy arrays (``np.asarray`` of each leaf; no JAX needed here)
and returns the port's ``state_dict``.  The reference stacks one pattern
period of blocks on a leading ``[G]`` axis (``groups/b<i>/...``, i <
period) and keeps the remainder unstacked (``tail/t<i>``); group g's
block i becomes layer ``g * period + i`` and tail block i layer ``G *
period + i``.  Each layer takes its own ``ln1``: the reference's scan
carries the NEXT block's ``ln1`` into a block's fused down GEMM (the
shifted stack), and the port's forward reads ``blocks[i + 1].ln1`` for
the same fold.  MLP weights arrive in the single-device xyz layout
``[1, K, N]`` and become ``[K, N]`` (``up``/``down`` only for a plain MLP);
the packed ``wqkv`` stays packed and interleaved.  Whisper's tree adds the
decoder blocks' ``lnx`` and unpacked ``xattn/{wq,wk,wv,wo}``, and the
encoder, ``encoder/blocks`` stacked over its ``n_enc_layers`` and
``encoder/final_norm``, which become ``encoder.blocks.<i>`` and
``encoder.final_norm``.  An MoE block's ``ffn`` (llama4) holds the fp32
``router [D, E]``, the expert stacks ``w_up``/``w_gate [E, D, F]`` and
``w_down [E, F, D]`` and the shared expert's ``shared_up``/``shared_gate``
``[D, F]`` and ``shared_down [F, D]``, as the reference stores them (no
xyz layout), which keep their names under ``blocks.<i>.ffn``.  An RG-LRU
block (recurrentgemma) holds ``mix/{in_x, in_g, conv, w_a, w_i, lam,
out}`` in place of ``attn``, in its groups and in its 2-block tail, which
keep their names under ``blocks.<i>.mix``.  An xLSTM block (xlstm-350m:
three groups of seven mLSTM blocks and one sLSTM block, no tail) holds
``ln1`` and ``mix`` alone, no ``ln2`` and no ``ffn``: an mLSTM's ``mix/
{up_x, up_g, conv, wq, wk, wv, w_i, w_f, b_i, b_f, norm, down}``, an
sLSTM's ``mix/{w_in, r, bias, norm, out}``.  Loading the result into a
``Model`` casts each leaf once to its parameter's dtype (the RG-LRU's
gates and the sLSTM's ``w_in``, ``param_dtype`` in the reference's tree,
widen exactly to the port's fp32; the xLSTM mixers' projections of a
float32 config round once to the compute dtype, as the reference's
``astype`` at use does).

``to_jax_params`` is the inverse: a ``state_dict`` back to the reference's
tree (the groups restacked, the MLP weights in the xyz layout ``[1, K,
N]``, the widened mixer weights, ``models.lm.WIDENED``, back at the
config's ``param_dtype``) with numpy
leaves, for ``checkpoint.CheckpointManager``; a bf16
tensor becomes its 2-byte words (``checkpoint.manager.BF16_WORDS``), which
``from_jax_params`` reads back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint.manager import BF16_WORDS, host_copy
from repro_torch.configs.base import ArchConfig
from repro_torch.core.maxeva_matmul import unshard_weight_xyz
from repro_torch.models.lm import WIDENED


_MLP = ("gate", "up", "down")


def _tensor(a: Any) -> torch.Tensor:
    """numpy leaf -> torch tensor.  A bf16 leaf comes through ``np.asarray``
    as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects;
    it goes through float32, which holds every bf16 value exactly.  A
    checkpoint's bf16 leaf is its 2-byte words, bit-cast back."""
    a = np.asarray(a)
    if a.dtype == BF16_WORDS:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _block(sd: Dict[str, torch.Tensor], p: str, blk: Dict[str, Any],
           g=None) -> None:
    """One reference block (entry ``g`` of a stacked group, or an unstacked
    tail block for ``g`` None) into the keys under prefix ``p``."""
    def leaf(a):
        return _tensor(a if g is None else a[g])
    for name in ("ln1", "lnx", "ln2"):
        if name in blk:
            sd[p + name] = leaf(blk[name])
    if "attn" in blk:
        sd[p + "attn.wqkv"] = leaf(blk["attn"]["wqkv"])
        sd[p + "attn.wo"] = leaf(blk["attn"]["wo"])
    for name, w in blk.get("mix", {}).items():
        sd[p + "mix." + name] = leaf(w)
    for name, w in blk.get("xattn", {}).items():
        sd[p + "xattn." + name] = leaf(w)
    for name, w in blk.get("ffn", {}).items():
        if name in _MLP:
            sd[p + "ffn." + name] = unshard_weight_xyz(leaf(w),
                                                       1).contiguous()
        else:   # the MoE's router, expert stacks and shared expert
            sd[p + "ffn." + name] = leaf(w)


def from_jax_params(cfg: ArchConfig, params: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """Reference parameter tree -> the port's ``Model.state_dict()``."""
    sd = {"embed": _tensor(params["embed"]),
          "final_norm": _tensor(params["final_norm"])}
    period = cfg.pattern_period
    for g in range(cfg.n_groups):
        for i in range(period):
            _block(sd, f"blocks.{g * period + i}.",
                   params["groups"][f"b{i}"], g)
    for i in range(len(cfg.tail_blocks)):
        _block(sd, f"blocks.{cfg.n_groups * period + i}.",
               params["tail"][f"t{i}"])
    if cfg.encdec:
        enc = params["encoder"]
        for i in range(cfg.n_enc_layers):
            _block(sd, f"encoder.blocks.{i}.", enc["blocks"], i)
        sd["encoder.final_norm"] = _tensor(enc["final_norm"])
    return sd


def _block_tree(sd: Dict[str, torch.Tensor], p: str,
                param_dtype: torch.dtype, kind: str = "") -> Dict[str, Any]:
    """The reference block (of kind ``kind``) of the port's keys under
    prefix ``p``."""
    blk: Dict[str, Any] = {}
    for key, t in sd.items():
        if not key.startswith(p):
            continue
        *path, name = key[len(p):].split(".")
        if path == ["mix"] and name in WIDENED.get(kind, ()):
            t = t.to(param_dtype)
        w = host_copy(t)
        if path == ["ffn"] and name in _MLP:
            w = w[None]    # the single-device xyz layout [1, K, N]
        node = blk
        for k in path:
            node = node.setdefault(k, {})
        node[name] = w
    return blk


def _stack(blocks):
    """Stack same-structured block trees on a leading axis."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def to_jax_params(cfg: ArchConfig, state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the reference's parameter tree, numpy
    leaves (the inverse of ``from_jax_params``)."""
    sd = state_dict
    period = cfg.pattern_period
    pdt = getattr(torch, cfg.param_dtype)
    tree: Dict[str, Any] = {"embed": host_copy(sd["embed"]),
                            "final_norm": host_copy(sd["final_norm"])}
    if cfg.n_groups > 0:
        tree["groups"] = {f"b{i}": _stack([
            _block_tree(sd, f"blocks.{g * period + i}.", pdt, kind)
            for g in range(cfg.n_groups)])
            for i, kind in enumerate(cfg.block_pattern)}
    tree["tail"] = {f"t{i}": _block_tree(
        sd, f"blocks.{cfg.n_groups * period + i}.", pdt, kind)
        for i, kind in enumerate(cfg.tail_blocks)}
    if cfg.encdec:
        tree["encoder"] = {
            "blocks": _stack([_block_tree(sd, f"encoder.blocks.{i}.", pdt)
                              for i in range(cfg.n_enc_layers)]),
            "final_norm": host_copy(sd["encoder.final_norm"])}
    return tree
