"""Neural-network programs of the port (`decode`: the paged decoder)."""
