"""Sort paths and orchestration.

Layer map (mirrors SURVEY.md §7):
  common     — key encodings, digit extraction, padding helpers (leaf)
  reference  — pure-jnp LSD radix sort, the in-package oracle (L0)
  segsort    — XLA sort wrappers in signed space: flat and segmented (L2)
  tiled      — flat sort orchestration over segsort (L2/L3)
  dispatch   — public API (L3)
"""
