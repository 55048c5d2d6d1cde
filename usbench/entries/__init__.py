"""The program's calls a request can make, one file an entry, found by the
name a traffic file gives (``spec.module("entries", name)``)."""
