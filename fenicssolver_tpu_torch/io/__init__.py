from . import meshio  # noqa: F401
