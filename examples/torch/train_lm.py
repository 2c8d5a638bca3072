"""End-to-end LM training driver on the PyTorch port: trains a transformer
from the assigned config family with the full substrate (checkpoint/resume,
preemption guard, watchdog, cosine schedule).

Default preset is CPU-sized; `--preset 100m --steps 300` is the paper-scale
run (same code path).

  PYTHONPATH=src python examples/torch/train_lm.py --steps 200 [--device cpu]
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    args = sys.argv[1:]
    if not any(a.startswith("--arch") for a in args):
        args = ["--arch", "granite-3-8b"] + args
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "200"]
    if not any(a.startswith("--ckpt-dir") for a in args):
        args += ["--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")]
    raise SystemExit(train_main(args))
