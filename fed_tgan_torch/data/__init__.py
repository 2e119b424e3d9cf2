"""Host data layer of the port: table meta, category encoders, decode to CSV."""
