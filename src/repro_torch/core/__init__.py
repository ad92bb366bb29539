"""Arena, write set, reconstruction registry and chain primitives."""
