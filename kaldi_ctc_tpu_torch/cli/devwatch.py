"""Device-init watchdog launcher: ``python -m kaldi_ctc_tpu_torch.cli.devwatch
<module> [args...]``.

Counterpart of ``kaldi_ctc_tpu/cli/devwatch.py``: the same exit codes,
messages and ``KCTPU_DEVICE_TIMEOUT``, with the probe on the device the
wrapped CLI will run on.

Failure-detection wrapper (SURVEY §5.3) for environments where acquiring
the accelerator can wedge: a driver or runtime that hangs inside device
initialisation when a new process attaches while the previous one is
still tearing down.  Multi-stage recipes
(``kaldi_ctc_tpu_torch/recipes/*/run.sh``) run one CLI process per stage
back-to-back, which hits exactly that window.

The wrapper probes the device from a daemon thread: the wrapped argv's
``--device`` (``--device X`` or ``--device=X``, also from a ``--config``
file), else ``cuda``, the port's CLIs' default.  For CUDA the probe runs
``torch.cuda.init()``, a tiny tensor op on the device and
``torch.cuda.synchronize()``; for the CPU, the tensor op alone.  If the
probe does not complete within ``KCTPU_DEVICE_TIMEOUT`` seconds (default
120) the process hard-exits with code **66** so the calling script can
retry.  A probe that fails (no CUDA device, a driver error) exits **65**
at once and the CLI does not run on another device.  On success the
target CLI module runs in this same process and reuses the initialised
context — the probe costs nothing.

The reference's analogue is the GPU-selection retry loop in
``src/cudamatrix/cu-device.cc`` (SelectGpuId retries acquiring a device
before giving up).
"""

import os
import runpy
import sys
import threading



EXIT_DEVICE_HANG = 66
EXIT_DEVICE_ERROR = 65


def probe_device(argv) -> str:
    """The device the wrapped CLI's argv asks for: its last ``--device``
    after ``--config`` expansion, else ``cuda``."""
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    device = "cuda"
    args = expand_config_args(list(argv))
    for i, a in enumerate(args):
        if a == "--device" and i + 1 < len(args):
            device = args[i + 1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
    return device


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m kaldi_ctc_tpu_torch.cli.devwatch "
              "<module> [args...]", file=sys.stderr)
        return 2
    timeout = float(os.environ.get("KCTPU_DEVICE_TIMEOUT", "120"))
    device = probe_device(argv[1:])

    done = threading.Event()
    failure = []  # exception from the probe thread, if any

    def probe():
        # initialisation alone is not enough: a wedged driver can create
        # the context fine and then hang on the first real operation, so
        # the probe round-trips an actual tiny computation.  A fast
        # deterministic failure (no device, driver error) must NOT be
        # classified as a wedge — it would otherwise eat the full
        # timeout and trigger pointless caller retries — so exceptions
        # are stashed and reported as a distinct exit code immediately.
        try:
            import torch
            dev = torch.device(device)
            if dev.type == "cuda":
                torch.cuda.init()
            (torch.zeros((8,), dtype=torch.float32, device=dev) + 1).sum()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except BaseException as e:  # noqa: BLE001 - report, don't mask
            failure.append(e)
        finally:
            done.set()

    t = threading.Thread(target=probe, daemon=True, name="devwatch-probe")
    t.start()
    completed = done.wait(timeout)
    if completed and failure:
        print(f"devwatch: device probe failed deterministically "
              f"({type(failure[0]).__name__}: {failure[0]}); exiting "
              f"{EXIT_DEVICE_ERROR} (not a wedge — do not retry)",
              file=sys.stderr, flush=True)
        return EXIT_DEVICE_ERROR
    if not completed:
        print(f"devwatch: the {device} probe did not complete within "
              f"{timeout:.0f}s — device acquisition is wedged; exiting "
              f"{EXIT_DEVICE_HANG} so the caller can retry",
              file=sys.stderr, flush=True)
        # hard exit: the init thread may be unkillably blocked in native
        # code, sys.exit would hang on interpreter teardown
        os._exit(EXIT_DEVICE_HANG)

    mod = argv[0]
    sys.argv = [mod] + argv[1:]
    runpy.run_module(mod, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
