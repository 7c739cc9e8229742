"""``python -m modular_audio_pipeline_tpu_torch``: the port's CLI (``cli.main``)."""

import logging
import sys

from .cli import main

if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
        level=logging.INFO,
        handlers=[logging.StreamHandler(sys.stdout)],
    )
    sys.exit(main())
