"""One module a kind of unit of work; a traffic file names its driver."""
