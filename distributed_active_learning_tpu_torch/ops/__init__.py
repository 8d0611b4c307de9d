"""Forest evaluation, training, scoring and selection of the port."""
