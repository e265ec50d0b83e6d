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
``Model`` casts each leaf once to its parameter's dtype, which is the
reference's: a float32 config's leaves (whisper's encoder and
cross-attention, paligemma's, xlstm's, internlm2's) stay the fp32
masters bit for bit, which the serving copy casts.

``to_jax_params`` is the inverse: a ``state_dict`` back to the reference's
tree (the groups restacked, the MLP weights in the xyz layout ``[1, K,
N]``) with numpy
leaves, for ``checkpoint.CheckpointManager``; a bf16
tensor becomes its 2-byte words (``checkpoint.manager.BF16_WORDS``), which
``from_jax_params`` reads back.

``opt_to_jax`` and ``opt_from_jax`` carry AdamW's state (``optim.
init_opt_state``: ``{"step", "m", "v"}``, one moment per parameter) the
same way: each moment tree is laid out as the parameters are, and an
int8 moment's ``{"q", "s"}`` (values [..., K, N], row scales [..., K, 1])
is two such trees, so a stacked group's row scales are the per-layer ones
stacked (the reference quantizes each stacked leaf's trailing rows, which
are the layers' rows).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint.manager import BF16_WORDS, host_copy
from repro_torch.configs.base import ArchConfig
from repro_torch.core.maxeva_matmul import unshard_weight_xyz


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


def _block_tree(sd: Dict[str, torch.Tensor], p: str) -> Dict[str, Any]:
    """The reference block of the port's keys under prefix ``p``, its
    leaves the tensors where they are (``_host`` or ``_stack`` copies them
    to the host)."""
    blk: Dict[str, Any] = {}
    for key, t in sd.items():
        if not key.startswith(p):
            continue
        *path, name = key[len(p):].split(".")
        w = t.detach()
        if path == ["ffn"] and name in _MLP:
            w = w[None]    # the single-device xyz layout [1, K, N]
        node = blk
        for k in path:
            node = node.setdefault(k, {})
        node[name] = w
    return blk


def _host(tree):
    """A block tree's leaves copied to the host (``host_copy``)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return host_copy(tree)


def _stack(blocks):
    """Stack same-structured block trees on a leading axis, each leaf on
    its tensors' device and then copied to the host once."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return host_copy(torch.stack(blocks))


def to_jax_params(cfg: ArchConfig, state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the reference's parameter tree, numpy
    leaves (the inverse of ``from_jax_params``)."""
    sd = state_dict
    period = cfg.pattern_period
    tree: Dict[str, Any] = {"embed": host_copy(sd["embed"]),
                            "final_norm": host_copy(sd["final_norm"])}
    if cfg.n_groups > 0:
        tree["groups"] = {f"b{i}": _stack([
            _block_tree(sd, f"blocks.{g * period + i}.")
            for g in range(cfg.n_groups)])
            for i in range(period)}
    tree["tail"] = {f"t{i}": _host(_block_tree(
        sd, f"blocks.{cfg.n_groups * period + i}."))
        for i in range(len(cfg.tail_blocks))}
    if cfg.encdec:
        tree["encoder"] = {
            "blocks": _stack([_block_tree(sd, f"encoder.blocks.{i}.")
                              for i in range(cfg.n_enc_layers)]),
            "final_norm": host_copy(sd["encoder.final_norm"])}
    return tree


def _is_q8(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _pick(tree: Any, key: str) -> Any:
    if _is_q8(tree):
        return tree[key]
    return {k: _pick(v, key) for k, v in tree.items()}


def _pair(q: Any, s: Any) -> Any:
    if isinstance(q, dict):
        return {k: _pair(q[k], s[k]) for k in q}
    return {"q": q, "s": s}


def _moments_to_jax(cfg: ArchConfig, moments: Dict[str, Any]) -> Any:
    if all(_is_q8(m) for m in moments.values()):
        return _pair(to_jax_params(cfg, {k: m["q"] for k, m in
                                         moments.items()}),
                     to_jax_params(cfg, {k: m["s"] for k, m in
                                         moments.items()}))
    if any(_is_q8(m) for m in moments.values()):
        raise ValueError("a moment tree mixing int8 and fp32 leaves")
    return to_jax_params(cfg, moments)


def _moments_from_jax(cfg: ArchConfig, tree: Any) -> Dict[str, Any]:
    leaves = []

    def walk(t):
        if _is_q8(t) or not isinstance(t, dict):
            leaves.append(t)
        else:
            for v in t.values():
                walk(v)
    walk(tree)
    if all(_is_q8(x) for x in leaves):
        q = from_jax_params(cfg, _pick(tree, "q"))
        sc = from_jax_params(cfg, _pick(tree, "s"))
        return {k: {"q": q[k], "s": sc[k]} for k in q}
    if any(_is_q8(x) for x in leaves):
        raise ValueError("a moment tree mixing int8 and fp32 leaves")
    return from_jax_params(cfg, tree)


def opt_to_jax(cfg: ArchConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's AdamW state -> the reference's ``{"step", "m", "v"}``
    tree with numpy leaves."""
    return {"step": host_copy(state["step"]),
            "m": _moments_to_jax(cfg, state["m"]),
            "v": _moments_to_jax(cfg, state["v"])}


def opt_from_jax(cfg: ArchConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's AdamW state (numpy leaves) -> the port's, CPU
    tensors (``{"q", "s"}`` pairs for int8 moments)."""
    return {"step": _tensor(tree["step"]),
            "m": _moments_from_jax(cfg, tree["m"]),
            "v": _moments_from_jax(cfg, tree["v"])}
