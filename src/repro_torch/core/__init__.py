"""Core: the paper's contribution — CapsNet, dynamic routing, LAKP pruning
and the approximate math of Eq. 2/3."""
