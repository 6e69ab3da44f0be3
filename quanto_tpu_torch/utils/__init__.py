"""utils of quanto_tpu_torch: the safetensors reader and writer (`safetensors_io`)."""
