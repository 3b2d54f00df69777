"""Roofline analysis of the port's programs: ``analysis`` (the card's
figures, the terms, ``model_flops``) and ``op_cost`` (the counter that
prices an eager program per logical device of a mesh)."""
