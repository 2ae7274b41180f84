"""Kaldi ContextDependency (decision tree) reader/writer + lookups.

Counterpart of ``kaldi_ctc_tpu/utils/tree.py``: the same host code over
the port's modules.

The ``src/tree`` slice the CTC pipeline touches: the tree object written
by build-tree (``tree/context-dep.cc:145-152`` — tokens
``ContextDependency`` N P ``ToPdf`` <EventMap> ``EndContextDependency``)
with the EventMap node types of ``tree/event-map.cc``:

  * ``CE`` answer                      — ConstantEventMap (leaf / pdf id)
  * ``TE`` key size ( child... )      — TableEventMap (indexed by value)
  * ``SE`` key yes-set { yes no }     — SplitEventMap (set membership)
  * ``NULL``                          — absent child

Event keys: -1 is the pdf-class, 0..N-1 are phone-window positions
(``tree/context-dep.h``).  Monophone trees (the CTC recipe's
``build_tree.sh`` mono route) can also be *built* natively with
:func:`mono_tree`, removing the Kaldi fixture for the mono pipeline;
cluster-built triphone trees are consumed from Kaldi files.
"""

from __future__ import annotations

import dataclasses
import io
from typing import IO, List, Optional, Sequence, Tuple, Union

import numpy as np

from kaldi_ctc_tpu_torch.utils.kaldi_io import (
    _BINARY_MARKER,
    _read_basic_int32,
    _read_token,
    _write_basic_int32,
    _write_token,
)
from kaldi_ctc_tpu_torch.utils.transition_model import _read_int_vector_body

__all__ = ["ContextDependency", "read_tree", "write_tree", "mono_tree",
           "CE", "TE", "SE"]


# EventMap nodes as plain tuples (first element is the type tag):
#   ("CE", answer)
#   ("TE", key, [child-or-None, ...])
#   ("SE", key, frozenset(yes_values), yes_child, no_child)
def CE(answer: int):
    return ("CE", int(answer))


def TE(key: int, children: List):
    return ("TE", int(key), list(children))


def SE(key: int, yes_set: Sequence[int], yes, no):
    return ("SE", int(key), frozenset(int(v) for v in yes_set), yes, no)


@dataclasses.dataclass
class ContextDependency:
    """N = context width (1 = mono, 3 = triphone), P = central position."""

    N: int
    P: int
    root: tuple

    def pdf(self, phone_window: Sequence[int],
            pdf_class: int = 0) -> Optional[int]:
        """(phone window of length N, pdf-class) → pdf id, or None when
        the tree has no answer for this event (unseen context)."""
        if len(phone_window) != self.N:
            raise ValueError(f"window must have {self.N} phones")
        event = {-1: int(pdf_class)}
        for i, p in enumerate(phone_window):
            event[i] = int(p)
        node = self.root
        while node is not None:
            tag = node[0]
            if tag == "CE":
                return node[1]
            if tag == "TE":
                _, key, children = node
                val = event.get(key)
                if val is None or not 0 <= val < len(children):
                    return None
                node = children[val]
            elif tag == "SE":
                _, key, yes_set, yes, no = node
                val = event.get(key)
                node = yes if val in yes_set else no
            else:
                raise ValueError(f"bad EventMap node {tag}")
        return None

    @property
    def num_pdfs(self) -> int:
        """1 + max answer in the tree (ContextDependency::NumPdfs)."""
        best = -1
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is None:
                continue
            if node[0] == "CE":
                best = max(best, node[1])
            elif node[0] == "TE":
                stack.extend(node[2])
            else:
                stack.extend([node[3], node[4]])
        return best + 1


def mono_tree(num_phones: int, pdf_classes_per_phone: int = 1
              ) -> ContextDependency:
    """Monophone tree: phone p (1-based), pdf-class c → pdf
    (p-1)*C + c — what build-tree produces for the CTC recipe's
    1-state-per-phone mono topology (steps/ctc/build_tree.sh mono)."""
    c = pdf_classes_per_phone
    children: List = [None]  # phone 0 = eps has no pdf
    for p in range(1, num_phones + 1):
        if c == 1:
            children.append(CE(p - 1))
        else:
            children.append(TE(-1, [CE((p - 1) * c + k) for k in range(c)]))
    return ContextDependency(N=1, P=0, root=TE(0, children))


# ---------------------------------------------------------------------------
# Kaldi-binary I/O
# ---------------------------------------------------------------------------

def _read_event_map(f) -> Optional[tuple]:
    tok = _read_token(f)
    if tok == "NULL":
        return None
    if tok == "CE":
        return ("CE", _read_basic_int32(f))
    if tok == "TE":
        key = _read_basic_int32(f)
        size = _read_basic_int32(f)
        if _read_token(f) != "(":
            raise ValueError("TE: expected '('")
        children = [_read_event_map(f) for _ in range(size)]
        if _read_token(f) != ")":
            raise ValueError("TE: expected ')'")
        return ("TE", key, children)
    if tok == "SE":
        key = _read_basic_int32(f)
        yes_set = _read_int_vector_body(f)
        if _read_token(f) != "{":
            raise ValueError("SE: expected '{'")
        yes = _read_event_map(f)
        no = _read_event_map(f)
        if _read_token(f) != "}":
            raise ValueError("SE: expected '}'")
        return ("SE", key, frozenset(int(v) for v in yes_set), yes, no)
    raise ValueError(f"unknown EventMap token {tok!r}")


def _write_event_map(f, node: Optional[tuple]) -> None:
    if node is None:
        _write_token(f, "NULL")
        return
    tag = node[0]
    _write_token(f, tag)
    if tag == "CE":
        _write_basic_int32(f, node[1])
    elif tag == "TE":
        _write_basic_int32(f, node[1])
        _write_basic_int32(f, len(node[2]))
        _write_token(f, "(")
        for child in node[2]:
            _write_event_map(f, child)
        _write_token(f, ")")
    elif tag == "SE":
        _write_basic_int32(f, node[1])
        # ConstIntegerSet::Write == WriteIntegerVector (sorted)
        f.write(b"\x04")
        vals = sorted(node[2])
        f.write(np.int32(len(vals)).tobytes())
        f.write(np.asarray(vals, np.int32).tobytes())
        _write_token(f, "{")
        _write_event_map(f, node[3])
        _write_event_map(f, node[4])
        _write_token(f, "}")
    else:
        raise ValueError(f"bad EventMap node {tag}")


def read_tree(f_or_path: Union[str, IO[bytes]]) -> ContextDependency:
    """Parse a Kaldi tree file (binary mode, as build-tree writes)."""
    if isinstance(f_or_path, str):
        with open(f_or_path, "rb") as f:
            return read_tree(f)
    f = f_or_path
    marker = f.read(2)
    if marker != _BINARY_MARKER:
        raise ValueError("only Kaldi binary tree files are supported "
                         f"(got leading bytes {marker!r})")
    if _read_token(f) != "ContextDependency":
        raise ValueError("not a ContextDependency file")
    n = _read_basic_int32(f)
    p = _read_basic_int32(f)
    tok = _read_token(f)
    if tok == "ToLength":  # back-compat, discarded (context-dep.cc:166-170)
        _read_event_map(f)
        tok = _read_token(f)
    if tok != "ToPdf":
        raise ValueError(f"expected ToPdf, got {tok!r}")
    root = _read_event_map(f)
    if _read_token(f) != "EndContextDependency":
        raise ValueError("missing EndContextDependency")
    return ContextDependency(N=n, P=p, root=root)


def write_tree(f_or_path: Union[str, IO[bytes]],
               tree: ContextDependency) -> None:
    """Write in Kaldi binary format (readable by Kaldi's copy-tree)."""
    if isinstance(f_or_path, str):
        with open(f_or_path, "wb") as f:
            write_tree(f, tree)
        return
    f = f_or_path
    f.write(_BINARY_MARKER)
    _write_token(f, "ContextDependency")
    _write_basic_int32(f, tree.N)
    _write_basic_int32(f, tree.P)
    _write_token(f, "ToPdf")
    _write_event_map(f, tree.root)
    _write_token(f, "EndContextDependency")
