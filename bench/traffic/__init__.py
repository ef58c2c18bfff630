"""The traffic mixes (<traffic>.json) and the generators that read them."""
