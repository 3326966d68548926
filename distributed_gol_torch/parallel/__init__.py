"""Device health; the multi-device layer (meshes, halo exchange) is ROADMAP A8."""
