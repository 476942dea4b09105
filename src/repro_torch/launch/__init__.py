"""Launch surface of the port: device meshes (``mesh.py``)."""
