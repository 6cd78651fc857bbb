"""OSD-side modules of the port: the batching EncodeService, the pool and PG
types (`types`) and the OSDMap with its batched pool mappings (`osdmap`)."""
