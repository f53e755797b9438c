"""The ordering service: ticketing, the pipeline step and serving windows
on the device; the wire codecs, the ordered log and the lambda SPI on the
host."""
