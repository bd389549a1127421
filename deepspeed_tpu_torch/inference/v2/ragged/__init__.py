"""KV block allocation, sequence state and the ragged batch packer."""
