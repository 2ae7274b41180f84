"""Model families: everything the harness knows of a model, a file each.

A configuration file's ``family`` key names the module
``families/<family>.py``; a file without the key is ``google``.  A
family module gives, for a configuration ``cfg`` of its family:

- ``program_flags(cfg)``: the model flags of ``train_ctc``, a list of
  strings; ``model_file_config(cfg)``: the ``am`` config of the model
  file that ``serve --model`` loads;
- ``param_shapes(cfg)``: (name, shape) of every leaf of the program's
  parameter tree, named by its path (``rnn.0.dirs.1.w_x``) and listed in
  the order the program numbers its leaves (``jax.tree_util``'s: dict
  keys sorted, lists in order); ``make_params(cfg, seed, device)``: the
  flat leaves from the seed, on the device (``weights`` builds and
  flattens the tree from the names);
- ``logits(tree, feats, lens, cfg)``: the plain forward, feats [B, T, D]
  → logits [T', B, A], every product through ``reference.mm`` and every
  convolution through ``reference.conv2d``, so that the control's TF32
  rounds them all; ``output_lens(cfg, lens)``: T' of each utterance;
  ``time_stride(cfg)``: input frames a logit frame (``batches``' 2L+1
  rule reads it);
- ``forward_flops_per_frame(cfg)``: the forward's operations for one
  input frame of one utterance; ``layer_work(cfg, layer, frames,
  backward)``: {"flops", "bytes"} of a layer that ``kernels/*.json``
  names, over utterances of ``frames`` input frames, for the roofline
  readers (``flops``);
- ``features(cfg, pcm)``: the serving front end, int16 samples →
  [frames, D] f32.

Families import nothing of the program, and torch only inside the
functions that use it: the harness reads the flags and the time stride
before it starts the program, and torch's import there would add its
seconds to every run's set-up.  A new family is a new file.
"""

from __future__ import annotations

import importlib
import re

__all__ = ["DEFAULT", "NAME", "of"]

DEFAULT = "google"
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def of(cfg: dict):
    """The family module of configuration ``cfg``."""
    name = cfg.get("family", DEFAULT)
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad model family {name!r}")
    return importlib.import_module(f"asrbench.families.{name}")
