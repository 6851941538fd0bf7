"""Serving decode runtime: the device state of one serving engine and
its two steps, prefill and decode (counterpart of
`mxnet_tpu/serve/decode.py`).

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

Not ported yet (ROADMAP.md): the widened verify step
(`decode_multi`, speculative decoding) and int8 KV pages.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import profiler
from ..base import MXNetError
from ..models.transformer import (decode_embed, decode_project,
                                  decoder_layer_qkv, decoder_layer_self_post,
                                  decoder_layer_cross, decoder_layer_ffn,
                                  encode_memory, precompute_memory_kv)
from ..observability import tracer as _tracer
from ..ops.kernels import ragged_paged_attention
from .kv_pages import NULL_PAGE
from .quant import kv_page_bytes

__all__ = ["DecodeRuntime"]


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
        if int(width) != 1:
            raise MXNetError("the widened decode step (width > 1, "
                             "speculative decoding) is not ported yet "
                             "(ROADMAP.md, Queue 1: serving fast path)")
        if kv_dtype not in (None, "float32"):
            raise MXNetError(f"kv_dtype {kv_dtype!r} is not ported yet "
                             f"(ROADMAP.md, Queue 2: RPA int8 page path)")
        self._w = weights
        self._ew = enc_weights
        self.device = weights["embed"].device
        self.slots = int(slots)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.max_src_len = int(max_src_len)
        self.width = 1
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
        # compute dtype from the (always-fp) pos table
        self._dtype = weights["pos"].dtype
        self.reset_pages()
        self.reset_mem()

    # ---------------------------------------------------------- steps
    def _page_write(self, pages, li, page, off, vals):
        # in place: the JAX runtime's donated `pages.at[li, page, off]
        # .set(vals)`; inactive slots all land on the null page
        pages[li, page, off] = vals

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
            self._page_write(self.k_pages, li, page, off,
                             k.reshape(s_n, h, self._dh))
            self._page_write(self.v_pages, li, page, off,
                             v.reshape(s_n, h, self._dh))
            a = ragged_paged_attention(qh, self.k_pages[li],
                                       self.v_pages[li], page_tables,
                                       visible)
            x = decoder_layer_self_post(L, x, a.reshape(s_n, h * self._dh))
            x = decoder_layer_cross(L, h, x, self.mem_k[li], self.mem_v[li],
                                    self.mem_vl)
            x = decoder_layer_ffn(L, x)
        logits = decode_project(w, x)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

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
        s_n = self.slots
        npg = self.max_pages_per_slot
        # the four int arrays ride one host->device copy
        host = np.empty((s_n * (npg + 3),), np.int32)
        host[:s_n * npg] = np.asarray(page_tables, np.int32).reshape(-1)
        host[s_n * npg:] = np.concatenate([
            np.asarray(lens, np.int32).reshape(-1),
            np.asarray(tok, np.int32).reshape(-1),
            np.asarray(active, np.int32).reshape(-1)])
        dev = torch.from_numpy(host).to(self.device)
        page_tables_d = dev[:s_n * npg].view(s_n, npg)
        lens_d, tok_d, active_d = dev[s_n * npg:].view(3, s_n)
        with torch.no_grad():
            next_tok, logits = self._decode_core(page_tables_d, lens_d,
                                                 tok_d, active_d)
        return next_tok.cpu().numpy(), logits

    def remap_pages(self, mapping):
        """Apply a `PagePool.defrag()` renumbering to the device pools:
        one gather, copied back in place."""
        if not mapping:
            return
        perm = np.arange(self.num_pages)
        for old, new in mapping.items():
            perm[new] = old
        profiler.record_dispatch("serve_page_remap")
        idx = torch.from_numpy(perm).to(self.device)
        with torch.no_grad():
            self.k_pages.copy_(self.k_pages[:, idx])
            self.v_pages.copy_(self.v_pages[:, idx])

    def reset_pages(self):
        """Drop ALL cached KV state (construction, and the scheduler's
        catastrophic failure path after a step error, when page contents
        can no longer be trusted)."""
        shape = (self._n_layers, self.num_pages, self.page_size, self._h,
                 self._dh)
        self.k_pages = torch.zeros(shape, dtype=self._dtype,
                                   device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self._dtype,
                                   device=self.device)

    def kv_bytes_per_page(self):
        """Device bytes one page costs (K + V across layers)."""
        return kv_page_bytes(self._n_layers, self.page_size, self._h,
                             self._dh, self._dtype)

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
