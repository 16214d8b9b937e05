"""Instance-type catalog: the generator and the Resolver math."""
