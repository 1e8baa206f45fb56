from .function import StitchedFunction, stitch, tree_avals

__all__ = ["StitchedFunction", "stitch", "tree_avals"]
