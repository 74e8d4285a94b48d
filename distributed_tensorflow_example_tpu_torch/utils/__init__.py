"""Small shared helpers of the port."""
