"""Batched serving on the PyTorch port: prefill, then greedy decode through
the hand-written decode-attention kernel (the counterpart of
`examples/serve_lm.py`).

    PYTHONPATH=src python examples/serve_lm_torch.py                # GPU
    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-9b \\
        --smoke --batch 2 --prompt-len 24 --gen 8 --device cpu

With no arguments: gemma2-9b's smoke config, batch 2, a 24-token prompt,
8 tokens, on the GPU. Any `repro_torch.launch.serve` flag may be given.
"""
import sys

from repro_torch.launch.serve import main

DEFAULT = ["--arch", "gemma2-9b", "--smoke", "--batch", "2", "--prompt-len",
           "24", "--gen", "8"]

if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
