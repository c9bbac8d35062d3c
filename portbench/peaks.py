"""The table of peaks (``peaks.json``), by the name ``torch.cuda.get_device_name``
gives the card. A card that is not in the table has no roofline."""
import json
from pathlib import Path
from typing import Optional

from portbench.spec import ROOT


def hbm_bytes_per_s(kind: str, root: Path = ROOT) -> Optional[float]:
    with open(root / "portbench" / "peaks.json") as f:
        entry = json.load(f).get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])
