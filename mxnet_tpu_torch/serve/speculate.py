"""Draft proposers for speculative multi-token decoding.

The serving fast path drafts k tokens per turn and verifies them with
ONE batched pass through the widened decode executable
(`DecodeRuntime.decode_multi`); whatever the proposer gets wrong only
costs acceptance rate, never correctness — the committed tokens are
always the target model's own greedy choices. That freedom is why the
default proposer needs no draft model at all: n-gram / prompt-lookup
decoding (the self-speculation family) just searches the request's OWN
committed token history for the most recent earlier occurrence of its
current suffix and proposes the continuation that followed it. On the
prefix-heavy traffic the cache targets (templates, repetitive
structures, model output loops) that continuation is right often enough
to collapse several decode turns into one.

Host-side and allocation-free per turn: `known` is the request's
committed sequence (``[BOS] + prompt + generated``), a plain int list
that is at most `max_prompt_len + max_new_tokens` long.
"""
from __future__ import annotations

__all__ = ["propose_ngram"]


def propose_ngram(known, k, ngram=2):
    """Propose up to `k` draft tokens continuing `known` by prompt
    lookup: find the MOST RECENT earlier occurrence of the trailing
    `ngram` tokens (falling back to shorter suffixes, down to 1) and
    return the tokens that followed it. Returns [] when the history has
    no repeated suffix — the caller then runs the turn unspeculated."""
    n = len(known)
    k = int(k)
    if k <= 0 or n < 2:
        return []
    for g in range(min(int(ngram), n - 1), 0, -1):
        pat = known[n - g:]
        # latest j < n - g with known[j:j+g] == pat (the match may
        # overlap the suffix itself — periodic loops resolve correctly)
        for j in range(n - g - 1, -1, -1):
            if known[j:j + g] == pat:
                cont = known[j + g:j + g + k]
                if cont:
                    return [int(t) for t in cont]
                break   # suffix matched at j but nothing follows; a
                        # shorter suffix may still find a continuation
    return []
