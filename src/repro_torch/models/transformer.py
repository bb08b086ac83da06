"""The decoder stack (and the whisper encoder): serving and training.

Port of ``repro.models.transformer``.  The reference
stacks each period position's parameters over blocks and scans; the port
keeps one :class:`Block` per layer (layer ``i`` is block ``i // period``,
position ``i % period``) and loops over them.  Its cache holds one ring
per layer, written in place: ``{"layers": [{"k", "v", "pos",
"write_idx"}, ...], "len": int}``.

Parameters: the reference keeps f32 masters and casts each matrix to the
activation type where it is used.  The serving :class:`Transformer` casts
the matrices once, when it is built, which gives the same numbers (the
norms' scales stay f32, as the reference uses them).  Training,
:func:`forward_train`, runs on the parameter tree itself: f32 masters
(trainable leaves after ``repro_torch.optim.adamw_init``), each cast to
the activation type where it is used, the embedding before its gather
and the head before the f32 logits product, as in the reference.  Each
period block is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does.

Served and trained here: the decoder families of ``"attn"``, ``"local"``
and ``"mamba"`` layers (Mamba2 SSD mixers: mamba2, and jamba's hybrid of
both) with a gated MLP or a top-k MoE (its aux losses summed over the
layers into the training loss).  A Mamba layer's cache is its conv window
and its SSM state (``{"conv", "ssm"}``) where an attention layer has its
ring.  Besides text, the two modality stubs:

* ``"audio_stub"`` (whisper): a bidirectional encoder over the batch's
  precomputed frame embeddings (``encoder_embeds``, (B, T, d)), one layer
  at a time (:func:`_encode`), whose output every decoder layer reads by
  cross-attention after its self-attention.  Prefill stores it in the
  cache (``enc_out``) and each decode step attends to it again, its K and
  V projected anew in every layer at every step, as the reference does.
* ``"vision_stub"`` (qwen2-vl): the batch's patch embeddings
  (``patch_embeds``, (B, P, d)) go before the tokens; positions are the
  caller's M-RoPE positions (``positions``, (B, P + S, 3)) or 0..P+S-1 on
  all three sections.  Logits cover the tokens only, and the cache's
  ``len`` counts the patches too.

Under an LM mesh (``parallel.sharding``): :func:`forward_train` runs on
this rank's rows with the tree gathered over ``"data"`` (one period
block at a time under ``cfg.zero3 == "block"``), normalises its loss by
the whole batch's token count and adds the aux losses' share of its
batch rank, so the batch ranks' losses sum to the unsplit loss; a
``Transformer`` built with ``mesh`` holds its model rank's shards and
rings of its KV heads.  The embedding and the logits split the
vocabulary over ``"model"`` (:func:`_embed_tokens`, :func:`_lm_logits`);
the residual stream, which the reference pins to ``("batch", "seq",
"embed")``, is whole on every model rank.  Mamba2 mixers and the
encoder do not split over ``"model"`` (:func:`refuse_model_split`).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (_drop, active_mesh, flat_pspecs,
                                           gather_block_constraint,
                                           lm_shards, map_paths,
                                           mesh_context, rule_axes)

# parameter groups that are matrices, cast to the activation type at load
# (the MoE's nested ``shared`` group too; ``cross``: a decoder layer's
# cross-attention onto the encoder), and the leaves of those groups
# that stay f32: the router (the reference routes on its f32 master), a
# Mamba mixer's ``A_log`` and ``dt_bias`` (the reference exponentiates the
# one and adds the other in f32) and its nested norm's ``scale``
_MATRICES = ("mixer", "cross", "mlp", "moe")
_F32_LEAVES = ("router", "A_log", "dt_bias", "scale")
# nested groups a layer group may hold: the MoE's shared experts, a Mamba
# mixer's gated norm
_NESTED = {"moe": "shared", "mixer": "norm"}
# the MoE's aux losses, each summed over the layers (``forward_train``)
MOE_AUX = ("moe_lb", "moe_z")
# a layer's parameter groups, in the order the model holds them
_GROUPS = ("norm1", "mixer", "norm_cross", "cross", "norm2", "mlp", "moe")


def _moe_at(cfg: ModelConfig, pos: int) -> bool:
    if cfg.moe is None:
        return False
    return pos % cfg.moe.every == cfg.moe.every - 1


def _position_init(generator, cfg: ModelConfig, pos: int, device) -> dict:
    """One layer's f32 parameters at period position ``pos``: a Mamba2
    mixer at a ``"mamba"`` position, attention elsewhere, then (in an
    encoder-decoder model) the cross-attention and its norm."""
    p = {"norm1": L.rmsnorm_init(cfg.d_model, device),
         "mixer": (L.mamba_init(generator, cfg, device)
                   if cfg.pattern[pos] == "mamba"
                   else L.attention_init(generator, cfg, device))}
    if cfg.encoder is not None:
        p["norm_cross"] = L.rmsnorm_init(cfg.d_model, device)
        p["cross"] = L.attention_init(generator, cfg, device)
    if _moe_at(cfg, pos):
        p["norm2"] = L.rmsnorm_init(cfg.d_model, device)
        p["moe"] = L.moe_init(generator, cfg.d_model, cfg.moe, device)
    elif cfg.d_ff > 0:
        p["norm2"] = L.rmsnorm_init(cfg.d_model, device)
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, device)
    return p


def _encoder_layer_init(generator, cfg: ModelConfig, device) -> dict:
    """One encoder layer's f32 parameters: norm, attention, norm, gated
    MLP."""
    return {"norm1": L.rmsnorm_init(cfg.d_model, device),
            "mixer": L.attention_init(generator, cfg, device),
            "norm2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, device)}


def _leaf_type(group: str, name: str, dtype):
    """The type a leaf is held in by a model of activation type ``dtype``:
    the matrices in it, the norms, the router and a Mamba mixer's
    ``A_log`` and ``dt_bias`` in f32."""
    if group in _MATRICES and name not in _F32_LEAVES:
        return dtype
    return torch.float32


def _cast_group(group: str, leaves: dict, fn) -> dict:
    """``fn(tensor, leaf name)`` on every leaf of one layer group, nested
    groups (the MoE's ``shared``, a Mamba mixer's ``norm``) included."""
    return {n: (_cast_group(group, t, fn) if isinstance(t, dict)
                else fn(t, n)) for n, t in leaves.items()}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator], *,
                device=None, dtype: Optional[torch.dtype] = None,
                place=None) -> dict:
    """Random parameters from ``generator`` (on ``device``; None: torch's
    default generator), drawn in f32 layer by layer: ``{"embed",
    "final_norm", "layers": [...], "lm_head"?, "encoder"?}``, the encoder's
    ``{"layers": [...], "final_norm"}`` drawn last.  With ``dtype`` each
    matrix is cast to it as soon as it is drawn (the norms stay f32), so a
    bf16 model never holds its f32 weights whole; the values are those of
    the f32 draw, cast.  ``place(path, tensor)``, when given, maps each
    leaf (at its ``keystr`` path) as soon as it is drawn and cast, as a
    rank keeps its shard of it (``parallel.sharding.Sharding.shard``)."""
    def cast(t):
        return t if dtype is None else t.to(dtype)

    def placed(tree, path: str):
        return tree if place is None else map_paths(place, tree, path)

    def cast_layer(p):
        return {g: _cast_group(g, leaves, lambda t, n, g=g: t if dtype is None
                               else t.to(_leaf_type(g, n, dtype)))
                for g, leaves in p.items()}

    layers = [placed(cast_layer(_position_init(generator, cfg, i % cfg.period,
                                               device)), f"['layers'][{i}]")
              for i in range(cfg.n_layers)]
    params = {"embed": placed(cast(L._embed_init(
                  generator, (cfg.vocab, cfg.d_model), device)), "['embed']"),
              "final_norm": placed(L.rmsnorm_init(cfg.d_model, device),
                                   "['final_norm']"),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = placed(cast(L._dense_init(
            generator, (cfg.vocab, cfg.d_model), in_axis=-1, device=device)),
            "['lm_head']")
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [placed(cast_layer(_encoder_layer_init(generator, cfg,
                                                             device)),
                              f"['encoder']['layers'][{i}]")
                       for i in range(cfg.encoder.n_layers)],
            "final_norm": placed(L.rmsnorm_init(cfg.d_model, device),
                                 "['encoder']['final_norm']")}
    return params


def refuse_model_split(cfg: ModelConfig, mesh) -> None:
    """Tensor parallelism covers attention, the MLP, the MoE's experts
    and the vocabulary: a Mamba2 mixer or the whisper encoder and its
    cross-attention under more than one ``model`` rank raise (ROADMAP
    queue 1, item 4f-iii).  ``data`` and ``pod`` split every family."""
    if mesh is None or mesh.size("model") == 1:
        return
    what = [w for w, on in (("Mamba2 mixers", "mamba" in cfg.pattern),
                            ("the encoder and cross-attention",
                             cfg.encoder is not None)) if on]
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {' and '.join(what)} under model parallelism are "
            f"not split yet (ROADMAP queue 1, item 4f-iii); use a mesh of "
            f"data and pod ranks")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer: norm, attention or a Mamba2 mixer, (in an
    encoder-decoder model) norm and cross-attention, norm, then a gated
    MLP or a top-k MoE (neither where ``d_ff`` is 0 and the layer is not
    an MoE one).  An encoder layer is a Block of norm, attention, norm and
    MLP."""

    def __init__(self, p: dict, cfg: ModelConfig, pos: int, dtype, device):
        super().__init__()
        self.kind = cfg.pattern[pos]
        self.window = cfg.window if self.kind == "local" else 0

        def group(name, leaves):
            if leaves is None:
                return None
            return nn.ParameterDict({
                n: _frozen(t.to(device=device,
                                dtype=_leaf_type(name, n, dtype)))
                for n, t in leaves.items() if not isinstance(t, dict)})
        for name in _GROUPS:
            setattr(self, name, group(name, p.get(name)))
        # nested groups, held flat beside their parents
        self.moe_shared = group("moe", p.get("moe", {}).get("shared"))
        self.mixer_norm = group("mixer", p.get("mixer", {}).get("norm"))

    @property
    def params(self) -> dict:
        """The layer's parameter groups by name, as in the parameter
        tree (the MoE's ``shared`` nested in ``moe``, a Mamba mixer's
        ``norm`` in ``mixer``)."""
        out = {n: g for n in _GROUPS if (g := getattr(self, n)) is not None}
        for name, sub in _NESTED.items():
            nested = getattr(self, f"{name}_{sub}")
            if nested is not None:
                out[name] = {**out[name], sub: dict(nested)}
        return out


class Transformer(nn.Module):
    """A decoder (with whisper's encoder) on one device, in
    ``cfg.activation_dtype``.

    ``params``: the port's parameter tree (:func:`init_params`, or
    :func:`repro_torch.models.convert.params_from_jax` for the reference's
    weights); without it the weights are drawn from a ``torch.Generator``
    seeded with ``seed`` on the device.  ``device=None`` is the GPU (and
    raises without one).  ``use_kernel=False`` keeps prefill's attention
    on the plain route on the GPU too.

    A batch is ``{"tokens": (B, S)}`` plus the modality stub's inputs:
    ``encoder_embeds`` (B, T, d) for whisper, ``patch_embeds`` (B, P, d)
    and optionally ``positions`` (B, P + S, 3) for qwen2-vl.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 device=None, seed: int = 0, use_kernel: bool = True,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.mesh = mesh
        dt = cfg.activation_dtype
        place = None
        if mesh is not None:
            if mesh.size(("pod", "data")) > 1:
                raise ValueError("a served model splits over model ranks "
                                 "only: its mesh has no data or pod ranks")
            refuse_model_split(cfg, mesh)
            specs = {p: _drop(spec, "data") for p, spec in flat_pspecs(
                init_params(cfg, None, device="meta"), mesh).items()}
            place = functools.partial(_place, mesh, specs)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device, dtype=dt,
                                 place=place)
        elif place is not None:
            params = map_paths(place, params)
        self.embed = _frozen(params["embed"].to(device=self.device, dtype=dt))
        self.final_norm = _norm(params["final_norm"], self.device)
        self.lm_head = (None if cfg.tie_embeddings else _frozen(
            params["lm_head"].to(device=self.device, dtype=dt)))
        self.layers = nn.ModuleList(
            Block(p, cfg, i % cfg.period, dt, self.device)
            for i, p in enumerate(params["layers"]))
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(self.layers)} layers given, "
                             f"the config has {cfg.n_layers}")
        self.encoder = self.encoder_norm = None
        if cfg.encoder is not None:
            enc = params["encoder"]
            self.encoder = nn.ModuleList(Block(p, cfg, 0, dt, self.device)
                                         for p in enc["layers"])
            self.encoder_norm = _norm(enc["final_norm"], self.device)
            if len(self.encoder) != cfg.encoder.n_layers:
                raise ValueError(
                    f"{cfg.name}: {len(self.encoder)} encoder layers given, "
                    f"the config has {cfg.encoder.n_layers}")

    def _meshed(self):
        """The model's mesh made active (nothing without one)."""
        return (contextlib.nullcontext() if self.mesh is None
                else mesh_context(self.mesh))

    @property
    def head(self) -> torch.Tensor:
        """The output projection: the embedding where it is tied."""
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def encode(self, embeds) -> torch.Tensor:
        """The encoder's output (B, T, d) in the activation type for frame
        embeddings ``embeds`` (B, T, d)."""
        return _encode([b.params for b in self.encoder], self.encoder_norm,
                       self.cfg, _floats(embeds, self.device),
                       use_kernel=self.use_kernel)

    def _inputs(self, batch: dict):
        return _prepare_inputs(self.embed, self.cfg, batch, self.device,
                               self.encode)

    def forward(self, batch: dict) -> torch.Tensor:
        """Logits (B, S, V) in f32 at every position of ``batch["tokens"]``
        (the patches' positions left out): the full forward the
        reference's cache tests compare with."""
        with self._meshed():
            return self._forward(batch)

    def _forward(self, batch: dict) -> torch.Tensor:
        x, positions, enc_out, pad, own = self._inputs(batch)
        x = _stack(self, x, positions, enc_out=enc_out,
                   use_kernel=self.use_kernel, index_positions=own)
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return _lm_logits(self.head, self.cfg, x[:, pad:])

    def prefill(self, batch: dict, max_seq: int):
        """Run the prompt (and the patches before it) through the stack,
        returning (last_logits (B,1,V) f32, cache); an encoder-decoder
        model's cache also holds the encoder's output.  Under a mesh of
        model ranks each rank runs its heads and its rings hold them."""
        with self._meshed():
            return self._prefill(batch, max_seq)

    def _prefill(self, batch: dict, max_seq: int):
        cfg = self.cfg
        x, positions, enc_out, _, own = self._inputs(batch)
        b, s = x.shape[0], x.shape[1]
        cache = init_cache(cfg, b, max_seq, device=self.device)
        layer_caches = _with_write_idx(cache["layers"], 0)
        x = _stack(self, x, positions, enc_out=enc_out, caches=layer_caches,
                   use_kernel=self.use_kernel, index_positions=own)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = _lm_logits(self.head, cfg, x[:, -1:, :])
        cache["len"] = s
        if enc_out is not None:
            cache["enc_out"] = enc_out.to(cfg.activation_dtype)
        return logits, cache

    def decode_step(self, cache: dict, tokens,
                    batch_extras: Optional[dict] = None):
        """One decode step: tokens (B, 1).  Returns (logits (B,1,V) f32,
        cache), the cache updated in place.  An encoder-decoder model
        attends to the cache's ``enc_out``, or where the cache has none to
        the encoding of ``batch_extras["encoder_embeds"]``."""
        with self._meshed():
            return self._decode_step(cache, tokens, batch_extras)

    def _decode_step(self, cache: dict, tokens, batch_extras):
        cfg = self.cfg
        tokens = _tokens(tokens, self.device)
        b = tokens.shape[0]
        pos_scalar = cache["len"]
        x = _embed_tokens(self.embed, cfg, tokens)
        shape = (b, 1, 3) if cfg.rope == "mrope" else (b, 1)
        positions = torch.full(shape, pos_scalar, dtype=torch.int32,
                               device=self.device)
        enc_out = None
        if cfg.frontend == "audio_stub":
            if "enc_out" in cache:      # stored at prefill (no re-encode)
                enc_out = cache["enc_out"]
            elif batch_extras is not None:
                enc_out = self.encode(batch_extras["encoder_embeds"])
        layer_caches = _with_write_idx(cache["layers"], pos_scalar)
        x = _stack(self, x, positions, enc_out=enc_out, caches=layer_caches,
                   use_kernel=self.use_kernel)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = _lm_logits(self.head, cfg, x)
        cache["len"] = pos_scalar + 1
        return logits, cache


def _place(mesh, specs: dict, path: str, t: torch.Tensor) -> torch.Tensor:
    from repro_torch.parallel.sharding import Sharding
    return Sharding(mesh, specs[path]).shard(t)


def _norm(leaves: dict, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _frozen(
        leaves["scale"].to(device, torch.float32))})


# ---------------------------------------------------------------- blocks

def _apply_position(p: dict, kind: str, window: int, x, u, positions,
                    cfg: ModelConfig, cache=None, use_kernel: bool = True,
                    enc_out=None, causal: bool = True,
                    index_positions: bool = True):
    """One layer of ``kind`` (``"attn"``, ``"local"`` or ``"mamba"``) with
    parameter groups ``p`` (``norm1``, ``mixer``, ``norm_cross`` and
    ``cross`` in a decoder layer of an encoder-decoder model, and
    ``norm2`` with ``moe`` or ``mlp``) and sliding ``window`` (0: global).
    ``cache``: the layer's ring, or its conv and SSM states for a Mamba
    layer; it is written in place.  ``enc_out``: the encoder's output,
    which the ``cross`` group attends to after the self-attention, with no
    mask and no RoPE.  ``causal=False``: the encoder's bidirectional
    self-attention.  ``index_positions``: the positions are 0..s-1
    (:func:`layers.attention_apply`).  ``x`` is its input in the
    activation type, ``u`` the same value in f32 as the layer's first norm
    reads it.  Returns both for the layer's output, and the MoE's aux
    losses (``{}`` for other layers).

    Inside one compiled block the reference's residual sums reach the next
    norm unrounded (its compiler keeps the f32 sum of two bf16 values),
    while the residual adds themselves read them rounded to bf16; ``u``
    carries the unrounded sum.  In f32 ``u`` and ``x`` hold the same
    values."""
    dt = x.dtype
    normed = L.rmsnorm(p["norm1"], u, cfg.norm_eps).to(dt)
    if kind == "mamba":
        h, _ = L.mamba_apply(p["mixer"], normed, cfg, cache=cache)
    else:
        h, _ = L.attention_apply(p["mixer"], normed, positions, cfg,
                                 window=window, cache=cache, causal=causal,
                                 use_kernel=use_kernel,
                                 index_positions=index_positions)
    u = x.to(torch.float32) + h.to(torch.float32)
    x = u.to(dt)
    if enc_out is not None and "cross" in p:
        h, _ = L.attention_apply(
            p["cross"], L.rmsnorm(p["norm_cross"], u, cfg.norm_eps).to(dt),
            positions, cfg, kv_x=enc_out, causal=False, use_kernel=use_kernel)
        u = x.to(torch.float32) + h.to(torch.float32)
        x = u.to(dt)
    aux = {}
    if "moe" in p:
        h, aux = L.moe_apply(p["moe"], L.rmsnorm(p["norm2"], u, cfg.norm_eps)
                             .to(dt), cfg.moe)
    elif "mlp" in p:
        h = L.mlp_apply(p["mlp"], L.rmsnorm(p["norm2"], u, cfg.norm_eps)
                        .to(dt), tp=L.tp_group(cfg.d_ff))
    if "moe" in p or "mlp" in p:
        u = x.to(torch.float32) + h.to(torch.float32)
        x = u.to(dt)
    return x, u, aux


def _stack(model: Transformer, x, positions, enc_out=None, caches=None,
           use_kernel: bool = True, index_positions: bool = True):
    """Every layer in order.  ``caches``: one ring per layer (written in
    place), or None.  A period block starts from its input rounded to the
    activation type, as the reference's scan carries it."""
    cfg = model.cfg
    for i, p in enumerate(model.layers):
        if i % cfg.period == 0:
            u = x.to(torch.float32)
        x, u, _ = _apply_position(p.params, p.kind, p.window, x, u,
                                  positions, cfg,
                                  cache=None if caches is None else caches[i],
                                  use_kernel=use_kernel, enc_out=enc_out,
                                  index_positions=index_positions)
    return x


def _encoder_layer(x, positions, p: dict, cfg: ModelConfig,
                   use_kernel: bool = True):
    """One encoder layer: bidirectional self-attention and the gated MLP,
    from its input in the activation type (the reference's scan carries
    it rounded at every layer)."""
    x, _, _ = _apply_position(p, "attn", 0, x, x.to(torch.float32),
                              positions, cfg, use_kernel=use_kernel,
                              causal=False)
    return x


def _encode(layers: list, final_norm, cfg: ModelConfig, embeds, *,
            use_kernel: bool = True, remat: bool = False):
    """The bidirectional (whisper) encoder over precomputed frame
    embeddings ``embeds`` (B, T, d), cast to the activation type: each
    layer in turn at positions 0..T-1, then the final norm.  ``remat``
    recomputes each layer in the backward pass (see
    :func:`forward_train`)."""
    x = embeds.to(cfg.activation_dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, t)
    for p in layers:
        if remat:
            x = checkpoint(_encoder_layer, x, positions, p, cfg,
                           use_reentrant=False)
        else:
            x = _encoder_layer(x, positions, p, cfg, use_kernel)
    return L.rmsnorm(final_norm, x, cfg.norm_eps)


def _window(cfg: ModelConfig, pos: int) -> int:
    return cfg.window if cfg.pattern[pos] == "local" else 0


def _period_block(x, aux_sum: dict, positions, enc_out, layers: list,
                  cfg: ModelConfig, gather=None):
    """One period block of the training stack: its layers in order, from
    the block's input rounded to the activation type, as the reference's
    scan carries it.  Returns the block's output and ``aux_sum`` with each
    MoE layer's aux losses added in layer order.  ``gather``: ZeRO-3's
    per-block gather of the block's shards (``cfg.zero3 == "block"``),
    inside the recomputed region, so one block is gathered at a time."""
    if gather is not None:
        layers = gather(layers)
    u = x.to(torch.float32)
    aux_sum = dict(aux_sum)
    for pos, p in enumerate(layers):
        x, u, aux = _apply_position(p, cfg.pattern[pos], _window(cfg, pos),
                                    x, u, positions, cfg, enc_out=enc_out)
        for k, v in aux.items():
            aux_sum[k] = aux_sum[k] + v
    return x, aux_sum


def forward_train(params: dict, batch: dict, cfg: ModelConfig, *,
                  remat: bool = True):
    """Next-token cross-entropy of the parameter tree ``params`` (the
    port's layout; f32 masters, cast at use).  ``batch``: ``tokens`` and
    ``labels`` (B, S), a label of -1 masked out, and the modality stub's
    inputs (``encoder_embeds``; ``patch_embeds`` and optionally
    ``positions``).  Returns (loss, metrics): the mean over the unmasked
    tokens of logsumexp(logits) minus the gold logit, in f32, over the
    tokens' positions only (the patches' are left out), and ``{"ce",
    "ntokens"}``.  An MoE model adds each aux loss summed over its layers
    (from f32 zeros, layer by layer) over the layer count to the loss, and
    reports the sums as ``moe_lb`` and ``moe_z``.

    ``remat`` recomputes each period block in the backward pass instead of
    keeping its activations, as the reference's ``jax.checkpoint`` does,
    and each encoder layer too, where the reference's encoder scan keeps
    its activations: at whisper-large-v3's 4 x 1500 frames the plain
    attention's f32 scores and probabilities would keep ~2.5 GB a layer
    for the backward pass, ~80 GB over 32 layers.  Recomputation changes
    no number.  Attention takes the plain route wherever autograd records
    the forward (``layers.kernel_route``)."""
    device = params["embed"].device
    enc = params.get("encoder")
    mesh = active_mesh()
    refuse_model_split(cfg, mesh)
    block_gather = (mesh is not None and cfg.zero3 == "block"
                    and mesh.size("data") > 1)

    def encode(embeds):
        return _encode(enc["layers"], enc["final_norm"], cfg,
                       _floats(embeds, device), remat=remat)
    x, positions, enc_out, pad, _ = _prepare_inputs(params["embed"], cfg,
                                                    batch, device, encode)
    layers = params["layers"]
    aux = ({k: torch.zeros((), dtype=torch.float32, device=device)
            for k in MOE_AUX} if cfg.moe is not None else {})
    for start in range(0, cfg.n_layers, cfg.period):
        block = layers[start:start + cfg.period]
        gather = (functools.partial(_gather_block, lm_shards(cfg, mesh), start)
                  if block_gather else None)
        if remat:
            x, aux = checkpoint(_period_block, x, aux, positions, enc_out,
                                block, cfg, gather, use_reentrant=False)
        else:
            x, aux = _period_block(x, aux, positions, enc_out, block, cfg,
                                   gather)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = _lm_logits(head, cfg, x[:, pad:])               # (B,S,V) f32

    labels = _tokens(batch["labels"], device)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = (logz - gold) * mask
    axes = rule_axes("batch")
    group = None if mesh is None else mesh.group(axes)
    ntok = torch.clamp(mask.sum() if group is None
                       else C.all_reduce(mask.sum(), group), min=1.0)
    loss = ce.sum() / ntok
    metrics = {"ce": loss, "ntokens": ntok}
    for k, v in aux.items():
        loss = loss + (v / max(cfg.n_layers, 1) if group is None
                       else v / max(cfg.n_layers, 1) / mesh.size(axes))
        metrics[k] = v
    return loss, metrics


def _gather_block(shards, start: int, layers: list) -> list:
    return [gather_block_constraint(p, shards, f"['layers'][{start + j}]")
            for j, p in enumerate(layers)]


def _tokens(tokens, device) -> torch.Tensor:
    """Token ids (a tensor, array or nested list) as int64 on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.int64)


def _floats(a, device) -> torch.Tensor:
    """Embeddings (a tensor, or any array ``np.asarray`` takes, bf16 ones
    included) on ``device``, f32 unless a tensor of another float type."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a, dtype=np.float32))
    return a.to(device)


def _embed_tokens(embed, cfg: ModelConfig, tokens):
    """The embedding cast to the activation type, then gathered.  Under
    a mesh that splits the vocabulary over ``"model"`` each rank looks up
    the tokens of its rows (the others read 0) and the ranks' rows are
    summed: one term of each sum is not 0, so the row is exact."""
    tp = L.tp_group(cfg.vocab)
    if tp is None:
        x = embed.to(cfg.activation_dtype)[tokens]
    else:
        n = embed.shape[0]
        local = tokens - L.tp_rank() * n
        mine = ((local >= 0) & (local < n))[..., None]
        x = embed.to(cfg.activation_dtype)[torch.clamp(local, 0, n - 1)]
        x = C.reduce_from(x * mine.to(x.dtype), tp)
    if cfg.scale_embed:
        # sqrt(d_model) rounded to the activation type first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _lm_logits(head, cfg: ModelConfig, x):
    """f32 logits: the f32 product of x and the head cast to x's type,
    then gemma's softcap ``tanh(l / c) * c`` in f32.  Under a mesh that
    splits the vocabulary over ``"model"`` each rank takes its rows of
    the head and the ranks' logits are gathered along the vocabulary, so
    each logit is the unsplit contraction."""
    tp = L.tp_group(cfg.vocab)
    x = C.copy_to(x, tp)
    logits = torch.einsum("bsd,vd->bsv", x.to(torch.float32),
                          head.to(x.dtype).to(torch.float32))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return C.gather_from(logits, 2, tp)


def _prepare_inputs(embed, cfg: ModelConfig, batch: dict, device, encode):
    """Token embeds and the modality stubs -> (x, positions, enc_out, pad,
    own): the patches (vision stub) before the tokens, ``pad`` of them;
    the encoder's output ``encode(batch["encoder_embeds"])`` (audio stub;
    else None); the batch's ``positions``, or 0..len-1 (on all three
    M-RoPE sections under the vision stub), ``own`` telling which."""
    tokens = _tokens(batch["tokens"], device)
    x = _embed_tokens(embed, cfg, tokens)
    b, s = tokens.shape
    positions = batch.get("positions")
    enc_out, pad = None, 0
    if cfg.frontend == "vision_stub":
        patches = _floats(batch["patch_embeds"], device).to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        pad = patches.shape[1]
    elif cfg.frontend == "audio_stub":
        enc_out = encode(batch["encoder_embeds"])
    own = positions is None
    if own:
        n = x.shape[1]
        positions = torch.arange(n, dtype=torch.int32, device=device)
        positions = (positions[None, :, None].expand(b, n, 3)
                     if cfg.frontend == "vision_stub"
                     else positions[None, :].expand(b, n))
    else:
        positions = _tokens(positions, device).to(torch.int32)
    return x, positions, enc_out, pad, own


# ---------------------------------------------------------------- serving

def ring_size(cfg: ModelConfig, pos: int, max_seq: int) -> int:
    if cfg.pattern[pos] == "local":
        return min(max_seq, cfg.window + 8)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Allocate the decode cache: a KV ring per attention layer, every slot
    empty (``pos`` -1), and a Mamba layer's conv window (B, cw - 1, ch) in
    ``dtype`` and SSM state (B, nh, p, n) in f32, zeros; under the audio
    stub the encoder's output (B, T, d), zeros until prefill writes it."""
    dtype = dtype or cfg.activation_dtype
    kv = cfg.n_kv
    if L.tp_group(cfg.n_heads) is not None:
        # this rank's heads under a mesh of model ranks
        ranks = active_mesh().size("model")
        kv = (cfg.n_kv // ranks if L.tp_group(cfg.n_kv) is not None
              else cfg.n_heads // ranks)
    extra = {}
    if cfg.frontend == "audio_stub":
        extra["enc_out"] = torch.zeros(
            (batch, cfg.encoder.seq_len, cfg.d_model), dtype=dtype,
            device=device)
    layers = []
    for i in range(cfg.n_layers):
        if cfg.pattern[i % cfg.period] == "mamba":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            layers.append({
                "conv": torch.zeros(
                    (batch, s.conv_width - 1,
                     d_in + 2 * s.n_groups * s.d_state), dtype=dtype,
                    device=device),
                "ssm": torch.zeros((batch, d_in // s.head_dim, s.head_dim,
                                    s.d_state), dtype=torch.float32,
                                   device=device)})
            continue
        eff = ring_size(cfg, i % cfg.period, max_seq)
        shape = (batch, eff, kv, cfg.head_dim)
        layers.append({
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, eff), -1, dtype=torch.int32,
                              device=device),
            "write_idx": 0,
        })
    return {"layers": layers, "len": 0, **extra}


def _with_write_idx(layer_caches: list, pos_scalar: int) -> list:
    """Set each attention layer's ring write index to len % ring (a Mamba
    layer has no ring)."""
    for c in layer_caches:
        if "k" in c:
            c["write_idx"] = pos_scalar % c["k"].shape[1]
    return layer_caches
