"""Batched LM serving with continuous batching (prefill + decode slots) on
the PyTorch port.

  PYTHONPATH=src python examples/torch/serve_lm.py --requests 6 --slots 3 [--device cpu]
"""

import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    raise SystemExit(serve_main(sys.argv[1:]))
