"""The sharded paths of the port: a mesh of device slots driven from one
process (mesh.py) and the routed kmerize and pulldown steps (shuffle.py)."""
