"""Box geometry, decode, NMS and letterbox on torch tensors."""
