"""End-to-end serving example of the PyTorch port (the paper's kind: serve a
model behind the edge cache, batched requests, continuous batching).

    PYTHONPATH=src python examples/torch_serve_coic.py --requests 48
    PYTHONPATH=src python examples/torch_serve_coic.py --device cpu
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not any(a != "--device" and a.startswith("--") for a in argv):
        argv += ["--requests", "48", "--pool", "12", "--max-new", "12"]
    main(argv)
