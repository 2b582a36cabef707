"""Transaction corpora: synthetic generators, bitmap packing, CSR slabs."""
