"""Config-file expansion for CLI flags — the ParseOptions --config idiom.

Kaldi's ParseOptions supports ``--config=file`` where the file holds one
``--flag=value`` (or ``--flag value``) per line, read before the rest of
the command line so explicit flags win (``util/parse-options.h:36-118``).
``expand_config_args`` gives every CLI the same behaviour: it replaces
``--config FILE`` / ``--config=FILE`` occurrences in argv with the
file's tokens (comments with ``#`` allowed).
"""

from __future__ import annotations

import shlex
import sys
from typing import List, Optional

__all__ = ["expand_config_args"]


def expand_config_args(argv: Optional[List[str]]) -> List[str]:
    if argv is None:
        argv = sys.argv[1:]
    out: List[str] = []
    expanded: List[str] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        path = None
        if a == "--config":
            if i + 1 >= len(argv):
                raise SystemExit("--config requires a file argument")
            path = argv[i + 1]
            i += 2
        elif a.startswith("--config="):
            path = a.split("=", 1)[1]
            i += 1
        else:
            out.append(a)
            i += 1
            continue
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                expanded.extend(shlex.split(line))
    # config tokens go first so explicit command-line flags override
    # them — but AFTER any leading positionals (subcommand names), or
    # argparse would reject the unknown optionals before the subcommand
    n_pos = 0
    while n_pos < len(out) and not out[n_pos].startswith("-"):
        n_pos += 1
    return out[:n_pos] + expanded + out[n_pos:]
