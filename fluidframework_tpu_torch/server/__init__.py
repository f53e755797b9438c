"""The device half of the ordering service: ticketing and the pipeline step."""
