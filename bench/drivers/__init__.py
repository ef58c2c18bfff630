"""One module a kind of timed entry, named by a traffic file's "driver"."""
