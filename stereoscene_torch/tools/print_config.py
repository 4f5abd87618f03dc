"""Print the fully merged config as JSON, the port's counterpart of
``tools/misc/print_config.py`` (the reference tools/misc/print_config.py):
``_base_`` files merged as ``config.load_config`` merges them.

    python -m stereoscene_torch.tools.print_config CONFIG
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..config import load_config


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    args = p.parse_args(argv)
    print(json.dumps(load_config(args.config), indent=2, default=str))


if __name__ == "__main__":
    main()
