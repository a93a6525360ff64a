"""Analytic roofline model per (arch × cell × mesh)
(``repro/launch/analytic.py``), on the H100's constants.

Standard MFU/roofline accounting of one step: its FLOPs, HBM bytes and
collective bytes, and the three roofline terms. The dry run
(``launch/dryrun.py``) records it beside the counts it takes from a
traced step, as the reference records it beside its compiled HLO's; the
smoke (``chip_smoke.py``'s ``[cost]``) holds the card's measured rounds to
it. The arithmetic is the reference's, in the same order, so given the
reference's chip as a :class:`hlo_cost.Chip` every number equals the
reference's bit for bit; every public function takes ``chip=H100``.

All quantities are PER DEVICE unless suffixed ``_global``.

Conventions (bf16 activations/params, fp32 optimizer):
 * train FLOPs = 3× forward (fwd + 2× bwd) + remat recompute;
 * attention scores cost 4·B·S²·hd·Hq per layer forward (QKᵀ + PV),
   scaled by ``causal_factor`` (1.0 = full-block baseline schedule; 0.5 =
   block-skipping / flash schedule);
 * TP collectives: 2 all-reduces per layer fwd (attn out + mlp out), ring
   cost 2·(m-1)/m · bytes; backward doubles; decode/prefill = fwd only;
 * FSDP: per-layer param all-gather (fwd + bwd recompute) + grad
   reduce-scatter;
 * MoE: all-to-all dispatch+combine, 2 directions, k experts per token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..models import blocks
from .hlo_cost import H100, Chip, roofline_terms


@dataclasses.dataclass
class MeshModel:
    chips: int
    data: int  # total data-parallel ways (pod*data)
    model: int

    @classmethod
    def single(cls):
        return cls(chips=256, data=16, model=16)

    @classmethod
    def multi(cls):
        return cls(chips=512, data=32, model=16)


def layer_kinds(cfg):
    """The decoder's block kinds as the reference counts them: an
    encoder-decoder's decoder layers are attention layers."""
    if cfg.is_encoder_decoder:
        return ["attention"] * cfg.num_layers
    return blocks.layer_kinds(cfg)


def _attn_flops_fwd_global(cfg, batch: int, sq: int, skv: int,
                           causal_factor: float) -> float:
    """QK^T + PV matmul flops, all attention layers."""
    kinds = layer_kinds(cfg)
    n_attn = sum(1 for k in kinds if k == "attention")
    if cfg.is_encoder_decoder:
        n_attn = cfg.encoder_layers + cfg.num_layers  # self-attn
    per_layer = 4.0 * batch * sq * skv * cfg.head_dim * cfg.num_heads
    total = n_attn * per_layer * causal_factor
    if cfg.is_encoder_decoder:
        # decoder cross-attention: Sq_dec x Skv_mem
        total += 4.0 * cfg.num_layers * batch * sq * skv * cfg.head_dim * cfg.num_heads
    if cfg.attention == "local" and cfg.window_size:
        # windowed layers see at most `window` keys
        eff = min(cfg.window_size, skv)
        total = n_attn * 4.0 * batch * sq * eff * cfg.head_dim * cfg.num_heads
    return total


def _linear_recurrence_flops_fwd_global(cfg, batch: int, s: int) -> float:
    kinds = layer_kinds(cfg)
    out = 0.0
    if cfg.family == "ssm":
        # WKV: chunked form ~ O(S·N) matmuls per head ≈ 4·S·C·N per head
        h = cfg.d_model // cfg.rwkv_head_dim
        n = cfg.rwkv_head_dim
        chunk = 64
        out += cfg.num_layers * batch * h * (
            4.0 * s * chunk * n + 2.0 * s * n * n
        )
    n_rec = sum(1 for k in kinds if k == "recurrent")
    if n_rec:
        out += n_rec * batch * s * cfg.lru_width * 8.0  # elementwise scan ops
    return out


def causal_pair_fraction(seq: int, q_block: int, kv_block: int) -> float:
    """Fraction of (q-block, kv-block) pairs a block-skipping schedule
    computes for causal attention."""
    nq = -(-seq // q_block)
    nk = -(-seq // kv_block)
    pairs = sum(
        1
        for i in range(nq)
        for j in range(nk)
        if j * kv_block <= i * q_block + q_block - 1
    )
    return pairs / max(nq * nk, 1)


def _tokens(cfg, kind: str, batch: int, seq: int) -> int:
    """Tokens one step processes: an encoder-decoder trains on its frames
    and max(seq // 8, 16) text tokens; a decode step on one a sequence."""
    if kind == "train":
        return batch * (seq + max(seq // 8, 16)) if cfg.is_encoder_decoder \
            else batch * seq
    return batch * seq if kind == "prefill" else batch


def flops_cell(cfg, kind: str, batch: int, seq: int,
               causal_factor: float = None,
               remat: str = None) -> Dict[str, float]:
    """Global FLOPs for one step of this cell."""
    remat = remat if remat is not None else cfg.remat
    if causal_factor is None:
        if cfg.attn_impl in ("blocked", "flash") and cfg.attention == "global":
            # flash schedule skips fully-masked block pairs
            causal_factor = causal_pair_fraction(seq, cfg.q_block, cfg.kv_block)
        else:
            causal_factor = 1.0
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = _tokens(cfg, kind, batch, seq)
        dense_fwd = 2.0 * n_active * tokens
        attn_fwd = _attn_flops_fwd_global(cfg, batch, seq, seq, causal_factor)
        rec_fwd = _linear_recurrence_flops_fwd_global(cfg, batch, seq)
        fwd = dense_fwd + attn_fwd + rec_fwd
        recompute = 0.0
        if remat == "full":
            recompute = dense_fwd + rec_fwd  # attention recompute is inside
            # the flash VJP backward, counted in its 3.5x multiplier below
        elif remat == "dots":
            recompute = rec_fwd + 0.1 * dense_fwd
        # flash attention backward recomputes scores: fwd + 2.5x fwd
        total = 3.0 * (dense_fwd + rec_fwd) + 3.5 * attn_fwd + recompute
        return {"fwd": fwd, "total": total, "tokens": float(tokens)}
    if kind == "prefill":
        tokens = batch * seq
        dense_fwd = 2.0 * n_active * tokens
        attn_fwd = _attn_flops_fwd_global(cfg, batch, seq, seq, causal_factor)
        rec_fwd = _linear_recurrence_flops_fwd_global(cfg, batch, seq)
        fwd = dense_fwd + attn_fwd + rec_fwd
        return {"fwd": fwd, "total": fwd, "tokens": float(tokens)}
    # decode: 1 token per sequence against a cache of length `seq`
    dense_fwd = 2.0 * n_active * batch
    attn_fwd = _attn_flops_fwd_global(cfg, batch, 1, seq, 1.0)
    rec_fwd = _linear_recurrence_flops_fwd_global(cfg, batch, 1)
    fwd = dense_fwd + attn_fwd + rec_fwd
    return {"fwd": fwd, "total": fwd, "tokens": float(batch)}


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6 (train) or 2 (prefill, decode) x active params x tokens
    (``repro/launch/dryrun.py:59-71``)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * cfg.active_param_count() * _tokens(cfg, kind, batch, seq)


def _kv_cache_bytes_global(cfg, batch: int, seq: int) -> float:
    kinds = layer_kinds(cfg)
    n_attn = sum(1 for k in kinds if k == "attention")
    eff = min(cfg.window_size, seq) if cfg.attention == "local" else seq
    kv = 2.0 * n_attn * batch * eff * cfg.num_kv_heads * cfg.head_dim * 2
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_head_dim
        kv += cfg.num_layers * batch * h * cfg.rwkv_head_dim**2 * 4
    if cfg.family == "hybrid":
        n_rec = sum(1 for k in kinds if k == "recurrent")
        kv += n_rec * batch * cfg.lru_width * 4
    if cfg.is_encoder_decoder:
        kv += 2.0 * cfg.num_layers * batch * seq * cfg.num_kv_heads * cfg.head_dim * 2
    return kv


def bytes_cell(cfg, kind: str, batch: int, seq: int, mesh: MeshModel,
               remat: str = None) -> Dict[str, float]:
    """Per-device HBM bytes for one step."""
    remat = remat if remat is not None else cfg.remat
    p_bytes_g = cfg.param_count() * 2.0
    p_active_g = cfg.active_param_count() * 2.0
    act_unit = 2.0 * cfg.d_model  # bytes per token per tensor (bf16)
    layers = cfg.num_layers + (cfg.encoder_layers or 0)

    if kind == "train":
        tokens = _tokens(cfg, kind, batch, seq)
        # params sharded over all chips (FSDP+TP): read fwd + read bwd
        # (+ read for recompute), grads written+reduced, opt m/v read+write f32
        param_traffic = 3.0 * p_bytes_g + 2.0 * p_bytes_g  # reads + grad rw
        opt_traffic = 4.0 * cfg.param_count() * 4.0  # m,v read+write
        saved_per_layer = {"none": 12.0, "dots": 6.0, "full": 2.0}[remat]
        act_traffic = 2.0 * saved_per_layer * layers * tokens * act_unit
        total_g = param_traffic + opt_traffic + act_traffic
        return {"total": total_g / mesh.chips, "params_global": p_bytes_g}
    if kind == "prefill":
        tokens = batch * seq
        act_traffic = 2.0 * 4.0 * layers * tokens * act_unit
        kv = _kv_cache_bytes_global(cfg, batch, seq)
        total_g = p_active_g + act_traffic + kv
        return {"total": total_g / mesh.chips, "params_global": p_bytes_g}
    # decode: weight streaming + KV cache read
    kv = _kv_cache_bytes_global(cfg, batch, seq)
    total_g = p_active_g + kv + 4.0 * batch * layers * act_unit
    return {"total": total_g / mesh.chips, "params_global": p_bytes_g}


def collective_bytes_cell(cfg, kind: str, batch: int, seq: int,
                          mesh: MeshModel, *, fsdp: bool = None,
                          compression: float = 1.0) -> Dict[str, float]:
    """Per-device collective bytes for one step (ring cost model)."""
    if fsdp is None:
        fsdp = True if kind == "train" else (cfg.family == "moe")
    m, d = mesh.model, mesh.data
    ring_m = 2.0 * (m - 1) / m
    layers = cfg.num_layers + (cfg.encoder_layers or 0)

    if kind == "train":
        tokens = _tokens(cfg, kind, batch, seq)
        tokens_dev = tokens / d
        act_slice = tokens_dev * cfg.d_model * 2.0
        # TP: 2 all-reduce per layer fwd, 2 bwd (activations)
        tp = 4.0 * layers * ring_m * act_slice if m > 1 else 0.0
        out = {"tp_allreduce": tp}
        p_bytes_g = cfg.param_count() * 2.0
        if fsdp:
            # all-gather params fwd + bwd(recompute), reduce-scatter grads
            ag = 2.0 * (d - 1) / d * (p_bytes_g / m)
            rs = (d - 1) / d * (p_bytes_g / m) * 2.0  # grads f32/bf16 mix ~2x
            out["fsdp_allgather"] = ag
            out["grad_reducescatter"] = rs * compression
        else:
            out["grad_allreduce"] = (
                2.0 * (d - 1) / d * (p_bytes_g / m) * compression
            )
        if cfg.family == "moe" and m > 1:
            # tokens-over-data × experts-over-model: dispatch/expert products
            # are local; the expert-dim contraction in the combine induces
            # one activation all-reduce fwd (+2 bwd).
            out["moe_combine_allreduce"] = 3.0 * layers * ring_m * act_slice
        out["total"] = sum(out.values())
        return out

    tokens = batch * seq if kind == "prefill" else batch
    tokens_dev = tokens / d
    act_slice = tokens_dev * cfg.d_model * 2.0
    tp = 2.0 * layers * ring_m * act_slice if m > 1 else 0.0
    out = {"tp_allreduce": tp}
    if fsdp:
        p_bytes_g = cfg.param_count() * 2.0
        out["fsdp_allgather"] = (d - 1) / d * (p_bytes_g / m)
    if cfg.family == "moe" and m > 1:
        out["moe_combine_allreduce"] = 1.0 * layers * ring_m * act_slice
    out["total"] = sum(out.values())
    return out


def analytic_roofline(cfg, kind: str, batch: int, seq: int, mesh: MeshModel,
                      *, causal_factor: float = 1.0, fsdp: bool = None,
                      remat: str = None, compression: float = 1.0,
                      chip: Chip = H100) -> Dict[str, float]:
    if cfg.mesh_strategy == "dp":
        # model axis repurposed as data parallelism: no TP collectives
        mesh = MeshModel(chips=mesh.chips, data=mesh.chips, model=1)
    fl = flops_cell(cfg, kind, batch, seq, causal_factor, remat=remat)
    by = bytes_cell(cfg, kind, batch, seq, mesh, remat=remat)
    co = collective_bytes_cell(
        cfg, kind, batch, seq, mesh, fsdp=fsdp, compression=compression
    )
    flops_dev = fl["total"] / mesh.chips
    compute_s = flops_dev / chip.peak_flops
    memory_s = by["total"] / chip.hbm_bw
    collective_s = co["total"] / chip.link_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    n_active = cfg.active_param_count()
    mf = (6.0 if kind == "train" else 2.0) * n_active * fl["tokens"]
    bound = max(terms.values())  # perfect compute/comm overlap
    bound_serial = sum(terms.values())  # no overlap
    peak_total = mesh.chips * chip.peak_flops
    return {
        **terms,
        "dominant": dominant,
        "flops_per_device": flops_dev,
        "bytes_per_device": by["total"],
        "collective_bytes_per_device": co["total"],
        "collective_breakdown": co,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(fl["total"], 1.0),
        "step_time_lower_bound_s": bound,
        "step_time_serial_s": bound_serial,
        # headline score: model FLOPs over peak at the roofline-bound step time
        "mfu_overlap": mf / (peak_total * bound) if bound else 0.0,
        "mfu_serial": mf / (peak_total * bound_serial) if bound_serial else 0.0,
        "tokens": fl["tokens"],
    }


def round_roofline(cfg, batch: int, seq: int, steps: int,
                   chip: Chip = H100) -> Dict[str, float]:
    """One DrJAX round on one card: ``steps`` client train steps (cohort
    x local steps) of ``batch`` x ``seq`` tokens, each one ``flops_cell``
    and one ``bytes_cell`` on a mesh of one chip, with no collective term.
    ``bound_s`` is the larger term, ``model_flops`` the round's
    6 x active params x tokens."""
    one = MeshModel(chips=1, data=1, model=1)
    flops = flops_cell(cfg, "train", batch, seq)["total"] * steps
    nbytes = bytes_cell(cfg, "train", batch, seq, one)["total"] * steps
    terms = roofline_terms(flops, nbytes, 0.0, chip)
    return {**terms, "flops": flops, "bytes": nbytes,
            "bound_s": max(terms.values()),
            "model_flops": model_flops(cfg, "train", batch, seq) * steps}
