"""Drop-in compatible core API (processor / training / utils).

Mirrors the reference's ``src/deal_yolo_data/core`` public surface so the UI
layer and any saved configs/templates drive the PyTorch port unchanged.
"""
