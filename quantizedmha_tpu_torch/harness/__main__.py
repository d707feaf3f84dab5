"""`python -m quantizedmha_tpu_torch.harness` — the benchmark CLI."""

from quantizedmha_tpu_torch.harness.cli import main

if __name__ == "__main__":
    main()
