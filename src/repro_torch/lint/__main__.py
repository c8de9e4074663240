"""``python -m repro_torch.lint`` entry point."""
import sys

from repro_torch.lint import run_cli

if __name__ == "__main__":
    sys.exit(run_cli())
