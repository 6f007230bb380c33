"""billlint: every byte that crosses a tier boundary is billed where it
crosses.

PRs 2–3 proved "billed == crossed exactly" dynamically (byte-parity
tests); this pass enforces the property structurally so a new write path
cannot merge without its billing call.  The contract is a pairing table:

* a **write** to a disk-replica / sidecar memmap (``self._disk[...] =``,
  ``self._disk_q[...] =``, ``self._disk_scale[...] =``) must pair, in the
  same function, with a HOST→DISK billing call;
* a **read** (subscript load) of those memmaps is a disk→host promotion
  and must pair with a DISK→HOST billing call;
* every billing call's *kind* must be one the table knows for its
  direction — an unknown (src, dst, kind) triple is itself a finding, so
  the table stays the single source of truth.

A billing call is a ``self._record(seq, SRC, DST, kind, nbytes)`` or
``<log>.record(SRC, DST, kind, nbytes)`` whose tier arguments are the
module-level ``DEVICE`` / ``HOST`` / ``DISK`` constants and whose kind is
a string literal.  Coalesced helpers that intentionally delegate billing
to their callers (e.g. ``_read_sidecar``) carry an explanatory
``# leolint: waive[billlint] reason=...``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, FuncInfo, Index, walk_in_func

PASS_ID = "billlint"

#: memmap attributes whose subscript writes/reads are tier crossings
TRACKED_ATTRS = ("_disk", "_disk_q", "_disk_scale", "_pq_codes",
                 "_pq_codebook")

_TIERS = {"DEVICE", "HOST", "DISK"}

#: direction -> transfer kinds the billing schema knows.  Extending the
#: schema means extending this table (and docs/INVARIANTS.md) in the same
#: change — that is the point.
ALLOWED_KINDS = {
    # prefix_ref: by-reference warm-prefix adoption — bills ZERO bytes
    # (one op per adopted chunk, for audit); cow_copy/cow_read: the two
    # halves of a copy-on-write privatization (read the shared replica,
    # write the private one — exactly one chunk each way per layer);
    # kv_shared: a refcounted promotion of a shared chunk (same bytes as
    # "kv", attributed to the reading sequence, phys row ≠ seq row).
    # kv_recompute: a replica rebuilt from a prompt replay after checksum
    # rejection (same landing as "kv_replica", distinct kind so audits
    # can separate recovery traffic from first-write traffic);
    # kv_fallback: an fp16-replica promotion serving in place of a
    # quarantined packed sidecar (lossless degrade — full replica bytes
    # where the sidecar read would have been cheaper).
    # kv_swapout/kv_swapin: whole-sequence preemption — suspend drops a
    # victim's host copies (the write-through replica is already current,
    # so kv_swapout is a ZERO-byte audit op per released chunk, like
    # prefix_ref), and resume re-stages exactly those chunks disk→host
    # (CRC-verified read; kv_swapin bills the bytes that really cross).
    # pq_codes_write/pq_codes_read: the PQ abstract plane — uint8
    # nearest-centroid codes landing next to (not instead of) the min/max
    # boxes at cold ingest / requant re-encode, and the per-round code
    # gather that replaces an "abstract" read for code-valid disk chunks
    # (a degraded chunk bills "abstract" instead, so fallbacks are
    # visible in the ledger).
    ("HOST", "DISK"): {"kv_replica", "kv_append", "sidecar_repack",
                       "abstract", "prefix_ref", "cow_copy",
                       "kv_recompute", "kv_swapout", "pq_codes_write"},
    ("DISK", "HOST"): {"kv", "abstract", "sidecar_repack_read",
                       "kv_shared", "cow_read", "kv_fallback",
                       "kv_swapin", "pq_codes_read"},
    ("HOST", "DEVICE"): {"kv", "kv_append", "abstract", "kv_shared"},
    ("DEVICE", "HOST"): {"kv", "kv_append"},
}


def _tier_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name) and expr.id in _TIERS:
        return expr.id
    if isinstance(expr, ast.Attribute) and expr.attr in _TIERS:
        return expr.attr
    return None


def _tracked_attr(expr: ast.AST) -> Optional[str]:
    """'_disk' for a ``<anything>._disk[...]`` subscript base."""
    if isinstance(expr, ast.Subscript) \
            and isinstance(expr.value, ast.Attribute) \
            and expr.value.attr in TRACKED_ATTRS:
        return expr.value.attr
    return None


def _billing_calls(fi: FuncInfo) -> List[Tuple[int, str, str, Optional[str]]]:
    """(line, src, dst, kind-or-None) for every record/_record call whose
    consecutive-arg pair is two tier constants."""
    out = []
    for node in walk_in_func(fi.node):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("record", "_record")):
            continue
        args = node.args
        for i in range(len(args) - 1):
            src, dst = _tier_name(args[i]), _tier_name(args[i + 1])
            if src and dst:
                kind = None
                if i + 2 < len(args) \
                        and isinstance(args[i + 2], ast.Constant) \
                        and isinstance(args[i + 2].value, str):
                    kind = args[i + 2].value
                out.append((node.lineno, src, dst, kind))
                break
    return out


def run(index: Index) -> List[Finding]:
    findings: List[Finding] = []
    for fi in index.functions:
        if isinstance(fi.node, ast.Lambda):
            continue
        writes: List[Tuple[int, str]] = []
        reads: List[Tuple[int, str]] = []
        for node in walk_in_func(fi.node):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    attr = _tracked_attr(t)
                    if attr:
                        writes.append((node.lineno, attr))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load):
                attr = _tracked_attr(node)
                if attr:
                    reads.append((node.lineno, attr))
        bills = _billing_calls(fi)
        if writes or reads or bills:
            dirs: Set[Tuple[str, str]] = {(s, d) for _, s, d, _ in bills}
            for line, attr in writes:
                if ("HOST", "DISK") not in dirs:
                    findings.append(Finding(
                        fi.module.path, line, PASS_ID,
                        f"write to `{attr}` (host→disk replica/sidecar "
                        f"bytes) in {fi.qualname} with no HOST→DISK "
                        f"billing call in the same function"))
            for line, attr in reads:
                if ("DISK", "HOST") not in dirs:
                    findings.append(Finding(
                        fi.module.path, line, PASS_ID,
                        f"read of `{attr}` (disk→host promotion) in "
                        f"{fi.qualname} with no DISK→HOST billing call "
                        f"in the same function"))
            for line, src, dst, kind in bills:
                allowed = ALLOWED_KINDS.get((src, dst))
                if allowed is None:
                    findings.append(Finding(
                        fi.module.path, line, PASS_ID,
                        f"billing direction {src}→{dst} is not in the "
                        f"transfer↔bill pairing table"))
                elif kind is not None and kind not in allowed:
                    findings.append(Finding(
                        fi.module.path, line, PASS_ID,
                        f"billing kind '{kind}' is not a known "
                        f"{src}→{dst} transfer (table: "
                        f"{sorted(allowed)}) — extend "
                        f"billlint.ALLOWED_KINDS with the new transfer "
                        f"class"))
    return findings
