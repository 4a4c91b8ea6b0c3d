"""CLI entry point: `python -m auralis_tpu_torch.entrypoints.oai_server ...`
(reference console script `auralis.openai`, setup.py:30-34)."""
from ..server.oai_server import main

if __name__ == "__main__":
    main()
