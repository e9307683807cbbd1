"""Launcher of the PyTorch port's app: `streamlit run run_torch.py`."""

import sys
from pathlib import Path

root = Path(__file__).parent
if str(root) not in sys.path:
    sys.path.insert(0, str(root))

from deal_yolo_daya_tpu_torch.app import main

if __name__ == "__main__":
    main()
