"""Traffic kinds: ``kinds/<kind>.py`` runs the cells whose traffic file names
``"kind": "<kind>"``, found by that name (``spec.kind``)."""
