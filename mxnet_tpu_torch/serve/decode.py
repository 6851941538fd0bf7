"""Serving decode runtime: the device state of one serving engine and
its steps — prefill, the 1-wide decode and the widened verify step
(counterpart of `mxnet_tpu/serve/decode.py`).

All device state lives on this object: the K/V page pools
`(L, P, psize, H, dh)` and the per-slot encoder memory
`(L, slots, H, max_src_len, dh)` with its lengths. The scheduler only
ever hands it host-side int arrays. Where the JAX package donates these
buffers to a jitted executable, the port updates them in place: each
step writes into the same device tensors, so the paged cache never
doubles in device memory.

Slot conventions (shared with serve.scheduler):

  * inactive slots route their page writes to the pool's reserved null
    page 0 and their outputs are garbage the scheduler never reads — no
    branches on occupancy inside the step;
  * `lens[s]` is the number of cached positions BEFORE this step — also
    the position index of the token being decoded (BOS decodes at 0);
  * page tables are padded with the null page, so unused entries point
    at valid memory.

The per-layer math is `models.transformer`'s factored decode core
(`decode_embed` / `decoder_layer_*`); the encoder's attention is the
flash kernel and the decoder's self-attention is
`ops.kernels.ragged_paged_attention` — the CUDA kernels on the card,
their plain versions on the CPU.

Widened step (`width > 1`, speculative decoding): `decode_multi` runs a
window of `width` tokens per slot at consecutive positions in one step —
the drafted tokens verified by one pass, or prompt tokens teacher-forced
`width` at a time — through the widened attention kernels.

Int8 KV cache (`kv_dtype="int8"`): the page pools store int8 with
per-page / per-head f32 scales in parallel `(L, P, H)` arrays. Writes
keep a running-max scale per page: a token whose |K| exceeds the page's
range grows the scale and requantizes the page's rows (a no-op when the
scale does not move); a write at page offset 0 resets the page's content
and scale. Scales are indexed by page id, so prefix-cache sharing and
`remap_pages` carry them with their pages. The attention kernels
dequantize on load.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import profiler
from ..base import MXNetError
from ..models.transformer import (decode_embed, decode_project,
                                  decoder_layer_qkv, decoder_layer_self_post,
                                  decoder_layer_cross,
                                  decoder_layer_cross_multi,
                                  decoder_layer_ffn, encode_memory,
                                  precompute_memory_kv)
from ..observability import registry as _obs_registry
from ..observability import tracer as _tracer
from ..ops.kernels import ragged_paged_attention
from .kv_pages import NULL_PAGE
from .quant import kv_page_bytes

__all__ = ["DecodeRuntime"]


def _quant_page_write(pages, scales, li, page, off, vals):
    """Quantized paged K/V write with running-max per-page/per-head
    scales, in place. pages: (L, P, psize, H, dh) int8; scales: (L, P,
    H) f32; page/off: (...,) int64 target page ids / offsets (inactive
    rows routed to the null page by the caller); vals: (..., H, dh)
    token projections. Leading dims are (S,) for the 1-wide step and
    (S, W) for the widened one: page ids may repeat within a window, and
    every duplicate computes identical values (a scatter-max for the
    scales, the same requantized block for the content), so the order
    of the duplicate writes does not matter. Every value read — old
    scales, old page blocks, `fresh` — is computed before the first
    write."""
    f32 = scales.dtype
    h = scales.shape[-1]
    amax = vals.to(f32).abs().amax(dim=-1)                   # (..., H)
    # a write at offset 0 starts the page's life: zero the content AND
    # scale a previous owner left (scales only grow within a life)
    fresh = torch.zeros((pages.shape[1],), dtype=torch.bool,
                        device=pages.device)
    fresh[torch.where(off == 0, page, torch.full_like(page, NULL_PAGE))] \
        = True
    sc = scales[li]                                          # (P, H) view
    sc0 = torch.where(fresh[:, None], torch.zeros_like(sc), sc)
    flat = page.reshape(-1)
    new_sc = sc0.scatter_reduce(0, flat[:, None].expand(-1, h),
                                (amax / 127.0).reshape(-1, h), reduce="amax")
    old_g = sc[page]                                         # (..., H)
    new_g = new_sc[page]
    safe = new_g.clamp_min(1e-30)
    ratio = torch.where(new_g > 0, old_g / safe, torch.ones_like(old_g))
    blk = pages[li, page].to(f32)                    # (..., psize, H, dh)
    blk = torch.round(blk * ratio[..., None, :, None])
    blk = torch.where(fresh[page][..., None, None, None],
                      torch.zeros_like(blk), blk)
    tok = torch.clamp(torch.round(vals.to(f32) / safe[..., None]),
                      -127, 127)
    pages[li, page] = blk.to(torch.int8)
    pages[li, page, off] = tok.to(torch.int8)
    scales[li] = new_sc


class DecodeRuntime:
    """Device state + the prefill and decode steps of one serving engine.

    weights / enc_weights: `models.transformer.decoder_weights` /
    `encoder_weights` snapshots, on the device the runtime runs on."""

    def __init__(self, weights, enc_weights, slots, num_pages, page_size,
                 max_pages_per_slot, max_src_len, width=1, kv_dtype=None):
        u = weights["embed"].shape[1]
        h = weights["num_heads"]
        if u % h:
            raise MXNetError("units not divisible by heads")
        if kv_dtype not in (None, "float32", "int8"):
            raise MXNetError(f"kv_dtype must be None/'float32'/'int8', "
                             f"got {kv_dtype!r}")
        self.width = int(width)
        if self.width < 1:
            raise MXNetError("decode width must be >= 1")
        self.kv_quant = kv_dtype == "int8"
        self._w = weights
        self._ew = enc_weights
        self.device = weights["embed"].device
        self.slots = int(slots)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.max_src_len = int(max_src_len)
        self._h = h
        self._dh = u // h
        self._n_layers = len(weights["layers"])
        max_pos = weights["pos"].shape[0]
        if self.max_pages_per_slot * self.page_size > max_pos:
            raise MXNetError(
                f"page budget covers {self.max_pages_per_slot * page_size} "
                f"positions but the decoder pos table has only {max_pos}")
        enc_pos = enc_weights["pos"].shape[0]
        if self.max_src_len > enc_pos:
            raise MXNetError(
                f"max_src_len {self.max_src_len} exceeds the encoder pos "
                f"table ({enc_pos}) — every prefill would fail")
        # compute dtype from the (always-fp) pos table, not the embed,
        # which an int8 weight snapshot keeps in int8
        self._dtype = weights["pos"].dtype
        self.reset_pages()
        self.reset_mem()

    # ---------------------------------------------------------- steps
    def _page_write(self, li, page, off, kh, vh):
        """Write K/V rows into their pages in place (the JAX runtime's
        donated scatters); inactive rows all land on the null page."""
        if self.kv_quant:
            _quant_page_write(self.k_pages, self.k_scales, li, page, off, kh)
            _quant_page_write(self.v_pages, self.v_scales, li, page, off, vh)
        else:
            self.k_pages[li, page, off] = kh
            self.v_pages[li, page, off] = vh

    def _attend(self, li, qh, page_tables, visible):
        quant = self.kv_quant
        return ragged_paged_attention(
            qh, self.k_pages[li], self.v_pages[li], page_tables, visible,
            k_scales=self.k_scales[li] if quant else None,
            v_scales=self.v_scales[li] if quant else None)

    def _decode_core(self, page_tables, lens, tok, active):
        w, h, psize = self._w, self._h, self.page_size
        s_n = tok.shape[0]
        lens_l = lens.long()
        x = decode_embed(w, tok.long(), lens_l)              # (S, U)
        rows = torch.arange(s_n, device=self.device)
        page = page_tables.long()[rows, lens_l // psize]
        page = torch.where(active > 0, page, torch.full_like(page, NULL_PAGE))
        off = lens_l % psize
        visible = lens + 1
        for li, L in enumerate(w["layers"]):
            q, k, v = decoder_layer_qkv(L, x)
            # q is a column slice of the fused QKV output; the kernel
            # takes it contiguous
            qh = q.reshape(s_n, h, self._dh).contiguous()
            self._page_write(li, page, off, k.reshape(s_n, h, self._dh),
                             v.reshape(s_n, h, self._dh))
            a = self._attend(li, qh, page_tables, visible)
            x = decoder_layer_self_post(L, x, a.reshape(s_n, h * self._dh))
            x = decoder_layer_cross(L, h, x, self.mem_k[li], self.mem_v[li],
                                    self.mem_vl)
            x = decoder_layer_ffn(L, x)
        logits = decode_project(w, x)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _verify_core(self, page_tables, lens, toks, qlens, active):
        """The widened decode step: toks (S, W) window tokens per slot at
        positions lens..lens+W-1, qlens (S,) valid window lengths (rows
        past qlen write to the null page and their outputs are values
        the scheduler never commits). Returns logits for every window
        position, so one step verifies a whole drafted run. int8 mode:
        window writes that share a page combine through the quantized
        write's scatter-max scales."""
        w, h, psize = self._w, self._h, self.page_size
        s_n, width = toks.shape
        npages = page_tables.shape[1]
        rows = torch.arange(s_n, device=self.device)
        pos = lens.long()[:, None] + torch.arange(width,
                                                  device=self.device)[None]
        # rows past a slot's window may run past the position table; the
        # JAX gather clamps there, and so does this one (their outputs
        # are never committed)
        x = decode_embed(w, toks.long(),
                         pos.clamp_max(w["pos"].shape[0] - 1))  # (S, W, U)
        slot_page = torch.clamp(pos // psize, max=npages - 1)
        page = page_tables.long()[rows[:, None], slot_page]      # (S, W)
        valid = (torch.arange(width, device=self.device)[None, :]
                 < qlens.long()[:, None]) & (active[:, None] > 0)
        page = torch.where(valid, page, torch.full_like(page, NULL_PAGE))
        off = pos % psize
        visible = lens + 1
        for li, L in enumerate(w["layers"]):
            q, k, v = decoder_layer_qkv(L, x)
            qh = q.reshape(s_n, width, h, self._dh).contiguous()
            self._page_write(li, page, off,
                             k.reshape(s_n, width, h, self._dh),
                             v.reshape(s_n, width, h, self._dh))
            # query i sees positions 0..lens+i (its own included)
            a = self._attend(li, qh, page_tables, visible)
            x = decoder_layer_self_post(
                L, x, a.reshape(s_n, width, h * self._dh))
            x = decoder_layer_cross_multi(L, h, x, self.mem_k[li],
                                          self.mem_v[li], self.mem_vl)
            x = decoder_layer_ffn(L, x)
        logits = decode_project(w, x)                    # (S, W, V)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _upload(self, page_tables, *rows):
        """The page tables and the (S,) int rows in one host->device
        copy: (page_tables (S, npages), then each row)."""
        s_n = self.slots
        npg = self.max_pages_per_slot
        flat = [np.asarray(r, np.int32).reshape(-1) for r in rows]
        host = np.empty((s_n * npg + sum(f.size for f in flat),), np.int32)
        host[:s_n * npg] = np.asarray(page_tables, np.int32).reshape(-1)
        at = s_n * npg
        for f in flat:
            host[at:at + f.size] = f
            at += f.size
        dev = torch.from_numpy(host).to(self.device)
        out, at = [dev[:s_n * npg].view(s_n, npg)], s_n * npg
        for r, f in zip(rows, flat):
            out.append(dev[at:at + f.size].view(np.shape(r)))
            at += f.size
        return out

    def prefill(self, slot, src_tokens, src_len=None):
        """Encode one request's source into decode slot `slot`: pads to
        the static (1, max_src_len) shape, runs the encoder and the
        cross-attention K/V projection, and writes them into the slot's
        memory in place."""
        src = np.asarray(src_tokens, np.int64).reshape(-1)
        if src_len is None:
            src_len = src.size
        if src.size > self.max_src_len:
            raise MXNetError(f"source length {src.size} exceeds the "
                             f"server's max_src_len {self.max_src_len}")
        host = np.zeros((self.max_src_len + 1,), np.int64)
        host[:src.size] = src
        host[-1] = src_len
        dev = torch.from_numpy(host).to(self.device)   # one host->device copy
        padded, vl = dev[None, :-1], dev[-1:].to(torch.int32)
        profiler.record_dispatch("serve_prefill")
        with _tracer.span("serve.prefill", cat="serve",
                          args={"slot": int(slot), "src_len": int(src_len)}):
            with torch.no_grad():
                memory = encode_memory(self._ew, padded, vl)
                kv = precompute_memory_kv(self._w, memory)
                # in place: the JAX runtime's donated dynamic_update_slice
                self.mem_k[:, slot] = torch.stack([k[0] for k, _ in kv])
                self.mem_v[:, slot] = torch.stack([v[0] for _, v in kv])
                self.mem_vl[slot] = vl[0]

    def decode(self, page_tables, lens, tok, active):
        """One decode step for every slot: writes each active slot's K/V
        into its current page in place, runs the shared
        ragged-paged-attention launch per layer, returns (next_tok (S,)
        host int32, logits (S, V) device tensor). The host waits for the
        device once, for next_tok."""
        profiler.record_dispatch("serve_decode")
        dev = self._upload(page_tables, lens, tok, active)
        with torch.no_grad():
            next_tok, logits = self._decode_core(*dev)
        return next_tok.cpu().numpy(), logits

    def decode_multi(self, page_tables, lens, toks, qlens, active):
        """One widened decode turn for every slot: writes each active
        slot's window K/V into its pages in place, runs the widened
        ragged-paged-attention launch per layer with per-slot ragged
        query lengths, returns (next_tok (S, W) host int32, logits (S,
        W, V) device tensor). Greedy commits derived from these outputs
        are the tokens `decode` gives token by token."""
        if self.width == 1:
            raise MXNetError("decode_multi needs width > 1 (construct "
                             "DecodeRuntime(width=k+1))")
        profiler.record_dispatch("serve_decode")
        dev = self._upload(page_tables, lens, toks, qlens, active)
        with torch.no_grad():
            next_tok, logits = self._verify_core(*dev)
        return next_tok.cpu().numpy(), logits

    def remap_pages(self, mapping):
        """Apply a `PagePool.defrag()` renumbering to the device pools
        (and, int8 mode, the scale arrays: scales travel with their page
        ids): one gather each, copied back in place."""
        if not mapping:
            return
        perm = np.arange(self.num_pages)
        for old, new in mapping.items():
            perm[new] = old
        profiler.record_dispatch("serve_page_remap")
        idx = torch.from_numpy(perm).to(self.device)
        pools = [self.k_pages, self.v_pages]
        if self.kv_quant:
            pools += [self.k_scales, self.v_scales]
        with torch.no_grad():
            for t in pools:
                t.copy_(t[:, idx])

    def reset_pages(self):
        """Drop ALL cached KV state, scales included (construction, and
        the scheduler's catastrophic failure path after a step error,
        when page contents can no longer be trusted)."""
        shape = (self._n_layers, self.num_pages, self.page_size, self._h,
                 self._dh)
        dtype = torch.int8 if self.kv_quant else self._dtype
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        if self.kv_quant:
            sshape = (self._n_layers, self.num_pages, self._h)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
            _obs_registry().gauge("kv_page_scale_bytes").set(
                2 * self.k_scales.numel() * 4)
        else:
            self.k_scales = self.v_scales = None

    def kv_bytes_per_page(self):
        """Device bytes one page costs in this runtime's layout (K + V
        across layers; int8 mode includes the per-page scale rows)."""
        return kv_page_bytes(self._n_layers, self.page_size, self._h,
                             self._dh,
                             "int8" if self.kv_quant else self._dtype)

    def reset_mem(self):
        """Rebuild zeroed per-slot encoder memory."""
        shape = (self._n_layers, self.slots, self._h, self.max_src_len,
                 self._dh)
        self.mem_k = torch.zeros(shape, dtype=self._dtype,
                                 device=self.device)
        self.mem_v = torch.zeros(shape, dtype=self._dtype,
                                 device=self.device)
        self.mem_vl = torch.zeros((self.slots,), dtype=torch.int32,
                                  device=self.device)
