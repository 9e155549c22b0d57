"""Multi-device mapping over torch.distributed: the ('data', 'model')
mesh (mesh.py) and the row-sharded index with its collective step
(dist.py)."""
