"""The merge-tree engine of the port: segment state, op packing, the fused
apply and the summary-length pass."""
