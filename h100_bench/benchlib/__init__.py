"""The benchmark's own library: loading cells by name (`spec`), the
seeded inputs (`data`, `traffic`) and weights (`weights`), the operation
counts and peaks (`counts`), the reduction of a profiler trace
(`trace`), the comparisons that decide `correct` (`checks`) and the
glue that builds the program under test (`program`)."""
